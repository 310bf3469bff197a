"""Numeric constants and small host helpers shared across the port."""
