"""The port's synthetic data vs the JAX package's: ``SyntheticLMStream``
batches and ``synthetic_images`` byte-equal for every seed, shard and step
drawn here."""
import numpy as np
import pytest

from repro.data import synthetic as R
from repro_torch.data import synthetic as P


@pytest.mark.parametrize("seed,order,n_shards", [(0, 2, 1), (7, 3, 2),
                                                 (123, 1, 4)])
def test_lm_stream_batches_byte_equal(seed, order, n_shards):
    kw = dict(vocab_size=97, seq_len=33, global_batch=8, seed=seed,
              order=order, noise=0.1)
    for shard in range(n_shards):
        r = R.SyntheticLMStream(R.LMStreamConfig(**kw), shard=shard,
                                n_shards=n_shards)
        p = P.SyntheticLMStream(P.LMStreamConfig(**kw), shard=shard,
                                n_shards=n_shards)
        assert p.local_batch == r.local_batch == 8 // n_shards
        for step in (0, 1, 5, 1000):
            a, b = r.batch(step), p.batch(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                assert a[k].tobytes() == b[k].tobytes()
        it = iter(p)
        for step in range(3):
            assert next(it)["tokens"].tobytes() == \
                r.batch(step)["tokens"].tobytes()


def test_lm_stream_rejects_uneven_shards():
    with pytest.raises(AssertionError):
        P.SyntheticLMStream(P.LMStreamConfig(10, 4, 6), n_shards=4)


@pytest.mark.parametrize("seed,n,shape,classes", [
    (0, 16, (28, 28, 1), 10), (5, 7, (32, 32, 3), 10), (9, 3, (4, 5, 2), 3)])
def test_synthetic_images_byte_equal(seed, n, shape, classes):
    xr, yr = R.synthetic_images(seed, n, shape, classes)
    xp, yp = P.synthetic_images(seed, n, shape, classes)
    assert xp.dtype == np.float32 and yp.dtype == np.int32
    assert xp.shape == (n,) + shape
    assert xr.tobytes() == xp.tobytes() and yr.tobytes() == yp.tobytes()
