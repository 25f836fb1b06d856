"""Convnets and weight conversion."""
