"""Every seed a run uses, drawn from --seed: frame k's sample seed, step
k's, the warm-up's, the target's, and which frames the check takes."""
from __future__ import annotations

import numpy as np

_POOL = 4096


class Seeds:
    def __init__(self, seed: int):
        ss = np.random.SeedSequence(int(seed) % (1 << 64))
        words = ss.generate_state(_POOL + 2, dtype=np.uint32)
        self._frames = [int(w) for w in words[:_POOL]]
        self.warm = int(words[_POOL])
        self.target = int(words[_POOL + 1])
        self._pick = np.random.default_rng(ss.spawn(1)[0])

    def frame(self, k: int) -> int:
        """Frame k's (or step k's) sample seed, a uint32."""
        return self._frames[k % _POOL]

    def checked(self, n: int, count: int) -> list:
        """`count` of the n frames, drawn from the seed, in order."""
        return sorted(self._pick.choice(n, size=min(n, count),
                                        replace=False).tolist())
