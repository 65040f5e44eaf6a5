"""Training batches: ``batch`` rows of ``seq`` tokens a step, every row
drawn anew from the seed and the step, labels the next token.

Parameters: ``batch``, ``seq``, ``zipf_a`` (tokens follow a Zipf law of
this exponent folded onto the vocabulary, as text's marginals do, so the
loss is not that of uniform noise)."""

from __future__ import annotations

from typing import Dict

import numpy as np

LOOP = "train"


def batch_at(params: dict, seed: int, step: int, vocab: int
             ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 17, int(step)])
    z = rng.zipf(float(params["zipf_a"]),
                 size=(int(params["batch"]), int(params["seq"]) + 1))
    toks = (z % vocab).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Data:
    """The seeded stream, in the shape ``PrefetchingLoader`` reads
    (``batch_at(step)``)."""

    def __init__(self, params: dict, seed: int, vocab: int):
        self.params, self.seed, self.vocab = params, seed, vocab

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return batch_at(self.params, self.seed, step, self.vocab)
