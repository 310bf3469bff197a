"""Neural Image Field (NIF) environment lights for the port."""
