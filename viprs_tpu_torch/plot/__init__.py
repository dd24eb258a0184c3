from .diagnostics import plot_history  # noqa: F401
