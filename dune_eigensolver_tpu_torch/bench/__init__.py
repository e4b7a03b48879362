"""Roofline models and the timing helper of the kernel benchmarks."""
