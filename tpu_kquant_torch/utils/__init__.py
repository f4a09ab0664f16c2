"""Utilities: roofline accounting, profiling, per-kernel attribution and
the qmm kernel lab."""
