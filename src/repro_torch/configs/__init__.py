"""Per-architecture configs (exact public-literature numbers)."""
