"""Device math of the path tracer: RNG, camera, BxDFs, intersection,
the blocked tables and the path-trace megakernel."""
