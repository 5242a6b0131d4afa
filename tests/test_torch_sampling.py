"""The port's Feistel cohort sampler on the device
(``algorithms/sampling.py``) against its host sampler
(``fast_client_sampling``) and the JAX package's in-graph twin
(``fedml_tpu.algorithms.sampling.feistel_cohort_in_graph``), bitwise, over
domains from 2 clients to the sampler's limit (2**31 - 1): powers of four
and their neighbours, the FEMNIST flagship's 3400 and 1M; walked the
host's count of passes, and one more."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedml_tpu.algorithms import sampling as jax_sampling
from fedml_tpu.algorithms.fedavg import fast_client_sampling as jax_fast_sampling
from fedml_tpu_torch.algorithms import sampling
from fedml_tpu_torch.algorithms.fedavg import fast_client_sampling

DOMAINS = [2, 3, 5, 16, 17, 63, 64, 65, 100, 1023, 1025, 3400, 4096, 4097, 65536,
           65537, 1_000_000, 2 ** 30 + 1, 2 ** 31 - 1]


# one compiled program a domain, as the superstep traces it
_jax_in_graph = jax.jit(jax_sampling.feistel_cohort_in_graph, static_argnums=(1, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", DOMAINS)
def test_in_graph_cohort_matches_host_and_jax(n):
    """Rounds 0-7 and two large round indices, cohorts of 10 (or N - 1):
    the device sampler, walked the host's count of passes and one more
    (a pass leaves a value in range as it is), the host sampler and the JAX package's in-graph sampler agree
    bit for bit."""
    num = min(10, n - 1)
    for r in list(range(8)) + [123_456, 2 ** 31 - 2]:
        host = fast_client_sampling(r, n, num)
        vals, walks = sampling.feistel_host(r, n, num)
        keys = sampling.feistel_keys_block(r, 1)[0]
        assert np.array_equal(host, vals) and host.dtype == np.int64
        assert np.array_equal(host, jax_fast_sampling(r, n, num))
        tkeys = torch.from_numpy(keys.astype(np.int64))
        for w in (walks, walks + 1):
            got = sampling.feistel_cohort_in_graph(tkeys, n, num, walks=w)
            assert got.dtype == torch.int64 and np.array_equal(got.numpy(), host), (r, w)
        want = np.asarray(_jax_in_graph(jnp.asarray(keys), n, num))
        assert np.array_equal(want, host)
        assert len(set(host.tolist())) == num and host.max() < n


def test_flagship_rounds_and_walk_counts():
    """3400 clients, 10 a round, over 300 rounds (``chip_smoke.py`` phase
    10 runs 1000 on the card): the device sampler from the key block equals
    the host's every round, and a count of passes short of the host's
    leaves a value out of range (the count matters)."""
    keys = torch.from_numpy(sampling.feistel_keys_block(0, 300).astype(np.int64))
    short = 0
    for r in range(300):
        host, walks = sampling.feistel_host(r, 3400, 10)
        got = sampling.feistel_cohort_in_graph(keys[r], 3400, 10, walks=walks)
        assert np.array_equal(got.numpy(), host), r
        if walks:
            cut = sampling.feistel_cohort_in_graph(keys[r], 3400, 10, walks=walks - 1)
            assert (cut >= 3400).any()
            short += 1
    assert short > 0
    # the 300 rounds at once, walked the most passes any of them took
    most = max(sampling.feistel_host(r, 3400, 10)[1] for r in range(300))
    block = sampling.feistel_cohort_in_graph(keys, 3400, 10, walks=most)
    assert np.array_equal(block.numpy(), np.stack(
        [fast_client_sampling(r, 3400, 10) for r in range(300)]))


def test_key_schedule_and_geometry_match_jax():
    assert np.array_equal(sampling.feistel_keys_block(5, 3),
                          jax_sampling.feistel_keys_block(5, 3))
    assert sampling.feistel_keys_block(5, 3).dtype == np.uint32
    for n in DOMAINS:
        assert sampling.feistel_geometry(n) == jax_sampling.feistel_geometry(n)
    keys = np.array([2 ** 64 - 1, 2 ** 63, 1, 0], np.uint64)
    assert np.array_equal(sampling.split_keys(keys), jax_sampling.split_keys(keys))


def test_64_bit_lanes_match_numpy_uint64():
    """The (hi, lo) product and add against numpy's wrapping uint64, at
    operands with every limb set."""
    rng = np.random.RandomState(0)
    a = np.concatenate([rng.randint(0, 2 ** 63, 64, dtype=np.int64).astype(np.uint64) * 2
                        + 1, np.array([2 ** 64 - 1, 2 ** 32 - 1, 2 ** 32, 0], np.uint64)])
    for const in (sampling._GOLDEN, sampling._MIX):
        want = a * np.uint64(const)
        hi, lo = sampling._mul64(torch.from_numpy((a >> np.uint64(32)).astype(np.int64)),
                                 torch.from_numpy((a & np.uint64(0xFFFFFFFF)).astype(np.int64)),
                                 const >> 32, const & 0xFFFFFFFF)
        got = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(np.uint64)
        assert np.array_equal(got, want)
    b = a[::-1].copy()
    split = [torch.from_numpy(v.astype(np.int64)) for v in
             ((a >> np.uint64(32)), a & np.uint64(0xFFFFFFFF),
              (b >> np.uint64(32)), b & np.uint64(0xFFFFFFFF))]
    hi, lo = sampling._add64(*split)
    got = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(np.uint64)
    assert np.array_equal(got, a + b)


def test_domain_past_the_limit_raises():
    with pytest.raises(ValueError, match="N < 2\\*\\*31"):
        sampling.feistel_cohort_in_graph(torch.zeros(4, 2, dtype=torch.int64), 2 ** 31, 10,
                                         walks=0)
