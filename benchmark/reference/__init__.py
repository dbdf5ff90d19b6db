"""The benchmark's plain reference renderer.

Plain PyTorch, written from pbrt-v1's semantics as the renderer under test
states them (counter-based sample streams keyed by pixel, sample, bounce
and purpose), with its own reading of the scene files. It imports nothing
of the renderer under test and takes nothing it made: no acceleration
structure, no packed table, no sample. Every float computation runs in the
dtype it is given, so the same code is the precision control (bfloat16).
"""
