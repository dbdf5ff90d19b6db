"""jax.random's threefry streams as the port's core/jrandom.py draws them
(the edge samples of the boundary terms), held against JAX's per call;
split from test_torch_silhouette.py so no file holds more than ten
cases.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuprt_torch.core import jrandom


@pytest.mark.parametrize("call", [
    "key0", "key_neg", "split2", "split4", "uniform", "uniform_split",
    "rim_keys"])
def test_jrandom_matches_jax_random(call):
    """PRNGKey, split(key), split(key, 4) and uniform(key, (M,)) as
    silhouette.py calls them (:132, :235, :267, :279-281, :341, :453-459),
    bit for bit."""
    seeds = {"key_neg": -5, "rim_keys": 7 ^ 0x5F3E}.get(call, 3 + 104729)
    jk, tk = jax.random.PRNGKey(seeds), jrandom.PRNGKey(seeds)
    if call in ("key0", "key_neg"):
        got, want = tk, jk
    elif call.startswith("split"):
        n = 4 if call == "split4" else 2
        got, want = jrandom.split(tk, n), jax.random.split(jk, n)
    elif call == "uniform":
        got = jrandom.uniform(tk, (2055,)).view(torch.int32)
        want = jax.random.uniform(jk, (2055,)).view(jnp.int32)
    else:
        # A chain of splits, then draws from the last subkey.
        for _ in range(3):
            jk, jsub = jax.random.split(jk)
            tk, tsub = jrandom.split(tk)
        got = jrandom.uniform(tsub, (257,)).view(torch.int32)
        want = jax.random.uniform(jsub, (257,)).view(jnp.int32)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))
