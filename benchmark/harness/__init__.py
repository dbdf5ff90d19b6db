"""The benchmark harness of tpuprt_torch (see main.py)."""
