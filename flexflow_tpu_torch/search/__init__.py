"""The strategy cost model and simulator (their memory halves)."""
