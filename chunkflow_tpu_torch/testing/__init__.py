"""Fault injection for the worker loop's stage boundaries."""
