"""Device selection and identity."""
