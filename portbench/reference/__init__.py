"""The plain reference that decides `correct` (NumPy only)."""
