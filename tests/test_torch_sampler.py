"""The PyTorch port's sampler (``runtime/sampler.py``) and stochastic
verification (``runtime/spec.verify_sample``) against the JAX reference.

The filters are deterministic: their kept sets must equal the
reference's, their values within 1e-6, and on the rank axis (R = 2, 4
shards of the vocabulary) the port must give its R = 1 result.  The
draws cannot match JAX's PRNG stream: they are held by distribution,
within total variation 0.05 of the target, as the reference's own tests
hold its draws, and they must depend only on the generator given.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import sampler as JS

from repro_torch.runtime import sampler as TS
from repro_torch.runtime import spec as TSP
from test_torch_model import _shard_run

VOCAB, V_PAD = 60, 64
N_DRAWS = 20000
TV_TOL = 0.05


def _logits(seed, b=2, s=3, scale=2.0):
    """Seeded float32 logits (B, S, V_PAD); the padded tail holds the
    largest values, so a filter that forgets the pad keeps them."""
    rng = np.random.RandomState(seed)
    lg = (rng.randn(b, s, V_PAD) * scale).astype(np.float32)
    lg[..., VOCAB:] = 50.0
    return lg


def _on_ranks(lg: np.ndarray, r: int) -> torch.Tensor:
    b, s, v = lg.shape
    return torch.from_numpy(
        lg.reshape(b, s, r, v // r).transpose(2, 0, 1, 3).copy())


def _full(t: torch.Tensor) -> np.ndarray:
    """(R, B, S, V_loc) -> (B, S, R·V_loc)."""
    r, b, s, v = t.shape
    return t.permute(1, 2, 0, 3).reshape(b, s, r * v).numpy()


def _kept(a) -> np.ndarray:
    return np.asarray(a) > -1e29


FILTERS = {
    "mask_pad": (lambda x: JS._mask_vocab_pad(x, vocab_size=VOCAB,
                                               tp_axis="model"),
                 lambda x: TS._mask_vocab_pad(x, vocab_size=VOCAB)),
    "top_k_1": (lambda x: JS.apply_top_k(x, 1), lambda x: TS.apply_top_k(x, 1)),
    "top_k_7": (lambda x: JS.apply_top_k(x, 7), lambda x: TS.apply_top_k(x, 7)),
    "top_k_40": (lambda x: JS.apply_top_k(x, 40),
                 lambda x: TS.apply_top_k(x, 40)),
    "top_p_0.3": (lambda x: JS.apply_top_p(x, 0.3),
                  lambda x: TS.apply_top_p(x, 0.3)),
    "top_p_0.9": (lambda x: JS.apply_top_p(x, 0.9),
                  lambda x: TS.apply_top_p(x, 0.9)),
    "filtered_t0.7_k20_p0.8": (
        lambda x: JS.filtered_logits(x, vocab_size=VOCAB, temperature=0.7,
                                     top_k=20, top_p=0.8),
        lambda x: TS.filtered_logits(x, vocab_size=VOCAB, temperature=0.7,
                                     top_k=20, top_p=0.8)),
    "filtered_t1.3_p0.95": (
        lambda x: JS.filtered_logits(x, vocab_size=VOCAB, temperature=1.3,
                                     top_p=0.95),
        lambda x: TS.filtered_logits(x, vocab_size=VOCAB, temperature=1.3,
                                     top_p=0.95)),
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_filters_match_reference(name, mesh11):
    jfn, tfn = FILTERS[name]
    lg = _logits(list(FILTERS).index(name))
    want = np.asarray(_shard_run(mesh11, jfn, jnp.asarray(lg)))
    for r in (1, 2, 4):
        got = _full(tfn(_on_ranks(lg, r)))
        np.testing.assert_array_equal(_kept(got), _kept(want), err_msg=name)
        keep = _kept(want)
        np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert 0 < _kept(want).sum() < want.size


def _target(lg_row: np.ndarray, temperature, top_k, top_p) -> np.ndarray:
    """The filtered softmax over the vocabulary, in numpy: temperature,
    the k largest, then the smallest prefix reaching p (crossing token
    included)."""
    x = lg_row[:VOCAB].astype(np.float64) / temperature
    keep = np.ones(VOCAB, bool)
    if top_k:
        keep &= x >= np.sort(x)[::-1][top_k - 1]
    p = np.where(keep, np.exp(x - x.max()), 0.0)
    p /= p.sum()
    if top_p < 1.0:
        order = np.argsort(p)[::-1]
        cut = int(np.searchsorted(np.cumsum(p[order]), top_p)) + 1
        p = np.zeros_like(p)
        p[order[:cut]] = np.exp(x[order[:cut]] - x.max())
        p /= p.sum()
    return p


def _tv(ids: np.ndarray, p: np.ndarray) -> float:
    emp = np.bincount(ids, minlength=len(p))[:len(p)] / len(ids)
    return 0.5 * float(np.abs(emp - p).sum())


SETTINGS = [dict(temperature=1.0, top_k=0, top_p=1.0),
            dict(temperature=0.8, top_k=10, top_p=0.9)]


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("kw", SETTINGS, ids=["t1", "t0.8_k10_p0.9"])
def test_sample_draws_follow_the_target(kw, r):
    """20000 rows of the same logits, one draw each: within TV 0.05 of
    the filtered softmax, never outside its support or the vocabulary."""
    row = _logits(11, b=1, s=1, scale=1.0)[0, 0]
    lg = np.broadcast_to(row, (N_DRAWS, 1, V_PAD)).copy()
    gen = torch.Generator().manual_seed(0)
    ids = TS.sample(_on_ranks(lg, r), vocab_size=VOCAB, generator=gen,
                    **kw).numpy()
    p = _target(row, **kw)
    assert set(np.unique(ids)) <= set(np.flatnonzero(p))
    assert _tv(ids, p) < TV_TOL, (_tv(ids, p), kw, r)


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("kw", SETTINGS, ids=["t1", "t0.8_k10_p0.9"])
def test_verify_sample_first_token_follows_the_target(kw, r):
    """Rejection-sampling verification commits a first token distributed
    as the target at window row 0 whatever the draft: here one drafts the
    most likely token, one an unlikely one, one nothing, one a padded
    id."""
    row0 = _logits(12, b=1, s=1, scale=1.0)[0, 0]
    p = _target(row0, **kw)
    gamma = 2
    for first in (int(np.argmax(p)), int(np.argsort(p)[-3]), -1, V_PAD - 1):
        rng = np.random.RandomState(first + 5)
        win = np.concatenate([row0[None], rng.randn(gamma, V_PAD)]).astype(
            np.float32)
        lg = np.broadcast_to(win, (N_DRAWS, gamma + 1, V_PAD)).copy()
        draft = torch.tensor([[first, 3]] * N_DRAWS)
        gen = torch.Generator().manual_seed(1)
        n_acc, emit = TSP.verify_sample(_on_ranks(lg, r), draft, gen,
                                        vocab_size=VOCAB, **kw)
        got = torch.where(n_acc >= 1, draft[:, 0], emit).numpy()
        assert _tv(got, p) < TV_TOL, (_tv(got, p), first, kw, r)
        assert bool(((n_acc >= 1) <= (draft[:, 0] >= 0)).all())


def test_draws_depend_only_on_the_generator():
    """The same seed gives the same draws whatever the global RNG does;
    another seed gives others; no generator, no stochastic draw."""
    lg = _on_ranks(_logits(13, b=64, s=1, scale=1.0), 2)
    draft = torch.zeros(64, 1, dtype=torch.long)
    kw = dict(vocab_size=VOCAB, temperature=0.9, top_k=30)

    def draws(seed):
        gen = torch.Generator().manual_seed(seed)
        torch.manual_seed(seed + 7)
        a = TS.sample(lg[:, :, :1], generator=gen, **kw)
        torch.manual_seed(seed + 8)
        b = TSP.verify_sample(torch.cat([lg, lg], dim=2), draft, gen, **kw)
        return torch.cat([a, *b])

    assert torch.equal(draws(0), draws(0))
    assert not torch.equal(draws(0), draws(1))
    with pytest.raises(ValueError):
        TS.sample(lg, temperature=0.5, vocab_size=VOCAB)


def test_greedy_sample_is_the_sharded_argmax(mesh11):
    lg = _logits(14, b=4, s=1)
    lg[0, 0, :VOCAB] = 1.0                      # all tied: smallest id
    want = np.asarray(_shard_run(
        mesh11, lambda x: JS.sample(x, vocab_size=VOCAB, temperature=0.0),
        jnp.asarray(lg)))
    for r in (1, 2, 4):
        got = TS.sample(_on_ranks(lg, r), vocab_size=VOCAB).numpy()
        np.testing.assert_array_equal(got, want)
    assert want[0] == 0
