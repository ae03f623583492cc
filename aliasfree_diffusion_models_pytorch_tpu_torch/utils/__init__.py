"""Kernel build/load, weight conversion and image IO."""
