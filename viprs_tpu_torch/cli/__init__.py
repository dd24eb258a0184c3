"""Command-line entry points of the port (``viprs_fit_torch``)."""
