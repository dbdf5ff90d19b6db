"""Gradients of the boundary (visibility) terms (port of tpuprt/diff)."""
