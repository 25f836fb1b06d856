"""Bundled plugins that publish to AWS services."""
