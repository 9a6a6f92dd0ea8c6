"""Evaluation metrics of the port: copies of :mod:`mvlt_tpu.metrics`
modules (numpy only), held against them bitwise by the tests."""
