"""The chained-command CLI."""
