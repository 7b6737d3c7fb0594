"""The port's hamming_backtrack_1 (the -N 1 seed search) against the JAX
package's on the CPU: every output equal, on tests/test_backtrack.py's
two cases and on random seeds with N symbols and short lengths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.fmindex import build_fm_index
from nvbio_tpu.fmindex.backtrack import hamming_backtrack_1 as jax_bt1
from nvbio_tpu_torch.fmindex.backtrack import hamming_backtrack_1
from nvbio_tpu_torch.io.index_file import index_from_numpy


def _both(text, seeds, slens, sa_sample=16):
    """(reference, port) outputs, each as a dict of numpy arrays."""
    fm, ssa = build_fm_index(text, sa_sample=sa_sample)
    want = jax_bt1(fm, jnp.asarray(seeds),
                   None if slens is None else jnp.asarray(slens))
    tfm, _, _, _ = index_from_numpy(
        [np.asarray(x) for x in fm[:6]], [np.asarray(x) for x in ssa], text)
    got = hamming_backtrack_1(
        tfm, torch.from_numpy(seeds),
        None if slens is None else torch.from_numpy(slens))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _assert_equal(want, got):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


def _case_exact_counts():
    """tests/test_backtrack.py:15's inputs."""
    rng = np.random.default_rng(0)
    n = 20000
    text = rng.integers(0, 4, n).astype(np.uint8)
    L, Nq = 12, 20
    starts = rng.integers(0, n - L, Nq)
    seeds = np.stack([text[s : s + L] for s in starts]).astype(np.int32)
    seeds[0, 5] = (seeds[0, 5] + 1) % 4
    seeds[1] = rng.integers(0, 4, L)
    slens = np.full(Nq, L, np.int32)
    slens[2] = 8
    return text, seeds, slens


def _case_seed_with_n():
    """tests/test_backtrack.py:46's inputs."""
    rng = np.random.default_rng(1)
    text = rng.integers(0, 4, 5000).astype(np.uint8)
    text[400:408] = text[200:208]
    text[404] = (text[404] + 1) % 4
    seeds = np.stack([text[100:108], text[200:208]]).astype(np.int32)
    seeds[0, 3] = 4
    return text, seeds, np.array([8, 8], np.int32)


def _case_random_n_and_short():
    """Seeds drawn from the text with substitutions, N symbols inside and
    beyond the seed length, and lengths from 1 to L."""
    rng = np.random.default_rng(7)
    text = rng.integers(0, 4, 12_000).astype(np.uint8)
    L, Nq = 16, 48
    starts = rng.integers(0, len(text) - L, Nq)
    seeds = np.stack([text[s : s + L] for s in starts]).astype(np.int32)
    sub = rng.random((Nq, L)) < 0.05
    seeds[sub] = (seeds[sub] + 1) % 4
    nmask = rng.random((Nq, L)) < 0.03
    seeds[nmask] = 4
    slens = rng.integers(1, L + 1, Nq).astype(np.int32)
    slens[:8] = L
    return text, seeds, slens


@pytest.mark.parametrize("case", [_case_exact_counts, _case_seed_with_n,
                                  _case_random_n_and_short],
                         ids=["exact_counts", "seed_with_n", "random_n_short"])
def test_backtrack_equals_reference(case):
    text, seeds, slens = case()
    want, got = _both(text, seeds, slens)
    _assert_equal(want, got)
    assert got["valid"].any()


def test_backtrack_default_lengths_equal_reference():
    """slens=None (every seed its full length), as candidate_stage calls
    it."""
    text, seeds, _ = _case_random_n_and_short()
    want, got = _both(text, seeds, None)
    _assert_equal(want, got)
