"""The port's DataLoader (data/loader.py) against the reference package's:
for the same dataset and seed, the same batches in the same order, epoch
after epoch, with shuffling, sharding (wrap-padded to equal shards),
pad_to_multiple's pad rows and pad_mask, drop_last and the thread-pool
prefetch."""

import numpy as np
import pytest

from diffusionremotesensing_tpu.data.loader import DataLoader as JaxLoader
from diffusionremotesensing_tpu_torch.data.loader import DataLoader


class _Items:
    def __init__(self, n):
        rng = np.random.default_rng(n)
        self.x = rng.random((n, 4, 4, 3)).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "cond": np.int64(i)}


def _epochs(loader, epochs=3):
    out = []
    for e in range(epochs):
        loader.set_epoch(e)
        out.append(list(loader))
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, shuffle=False),
    dict(batch_size=3, seed=5, pad_to_multiple=4),
    dict(batch_size=3, seed=2, num_shards=3, shard_index=2, pad_to_multiple=4),
    dict(batch_size=4, seed=9, drop_last=True),
    dict(batch_size=2, seed=1, num_workers=3, prefetch=1),
])
def test_batches_equal_the_references(kw):
    ds = _Items(11)
    got, want = _epochs(DataLoader(ds, **kw)), _epochs(JaxLoader(ds, **kw))
    assert len(DataLoader(ds, **kw)) == len(JaxLoader(ds, **kw))
    for ge, we in zip(got, want):
        assert len(ge) == len(we) > 0
        for g, w in zip(ge, we):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    if kw.get("pad_to_multiple"):
        last = got[0][-1]
        assert last["x"].shape[0] % kw["pad_to_multiple"] == 0 and "pad_mask" in last
        assert last["pad_mask"].sum() < last["x"].shape[0]
