class OptimizationDivergence(Exception):
    """Raised when the optimization algorithm is diverging.

    Parity: viprs/utils/exceptions.py:1-6.
    """
