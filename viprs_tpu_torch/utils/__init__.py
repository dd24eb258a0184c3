"""Host-side helpers (NumPy only)."""
