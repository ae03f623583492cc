"""Tests of the benchmark: CPU tests at tiny sizes, and ``cuda``-marked tests
that run on the card (``python -m pytest portbench/tests -m cuda``)."""
