"""The brute-force numpy f64 oracle (the Embree role)."""
