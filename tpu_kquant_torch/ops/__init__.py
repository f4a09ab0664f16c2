"""Operators: the kernels with their plain versions, and the plain ops."""
