"""Host-side BVH build (orders the blocked triangle tables)."""
