"""Helpers of the port: the H100 roofline model (``roofline``)."""
