"""Models of the port (the single-model VIPRS fit so far)."""

from .base import BayesPRSModel
from .viprs import VIPRS

__all__ = ['BayesPRSModel', 'VIPRS']
