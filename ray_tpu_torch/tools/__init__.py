"""Tools run by hand on a GPU host (kernel tuning)."""
