"""The native golden model's loader (``native``)."""
