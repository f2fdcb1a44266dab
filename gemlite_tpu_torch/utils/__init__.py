# SPDX-License-Identifier: Apache-2.0
