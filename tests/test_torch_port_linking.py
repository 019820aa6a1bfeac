"""The port's tube linking (`step_tpu_torch/tubes/linking.py`) against the
JAX package's (`step_tpu/tubes/linking.py`), on the same inputs on the CPU.

Paths, trims and argmax picks must be equal; values and tube scores within
1e-5 (float32 sums in another order). The cases follow the linking tests of
`tests/test_nms.py`: continuity, the stride-aligned transition, suppression
finding the second actor, an exhausted clip trimmed rather than killed,
clip-mask padding, node-disjointness, Kadane on all-negative input, ties
and NaN scores.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu.tubes import linking as jl
from step_tpu_torch.tubes import linking as tl

VALUE_TOL = 1e-5
# The JAX functions under jit: one compile per case, where eager mode
# compiles every scan body anew on each call.
_STATIC = ("link_iou_weight", "k", "trim_thresh", "stride", "suppress_iou")
jax_link_tubes_k = jax.jit(jl.link_tubes_k, static_argnames=_STATIC)
jax_link_tubes = jax.jit(jl.link_tubes, static_argnames=("link_iou_weight", "stride"))
jax_multiclass_k = jax.jit(jl.link_tubes_multiclass_k, static_argnames=_STATIC)
jax_multiclass = jax.jit(jl.link_tubes_multiclass,
                         static_argnames=("link_iou_weight", "stride"))
jax_max_subarray_mask = jax.jit(jl.max_subarray_mask)


def _tube(box, T):
    return np.tile(np.asarray(box, np.float32), (T, 1))


def _random_tubes(rng, L, P, T, scale=40.0, min_size=10.0):
    tubes = rng.rand(L, P, T, 4).astype(np.float32) * scale
    tubes[..., 2:] += tubes[..., :2] + min_size
    return tubes


def _continuity():
    L, P, T = 3, 2, 4
    tubes = np.zeros((L, P, T, 4), np.float32)
    for l in range(L):
        tubes[l, 0] = _tube([10, 10, 50, 50], T)
        x = 200 * ((l % 2) + 0.1)
        tubes[l, 1] = _tube([x, 10, x + 40, 50], T)
    return tubes, np.full((L, P), 0.5, np.float32), {}


def _stride_aligned(stride):
    def make():
        L, P, T = 2, 2, 4
        box = lambda v: [5.0 * v, 0.0, 5.0 * v + 10.0, 10.0]  # noqa: E731
        tubes = np.zeros((L, P, T, 4), np.float32)
        for t in range(T):
            tubes[0, 0, t] = box(t)
            tubes[1, 0, t] = box(t + 2)
        tubes[0, 1, :] = [50, 50, 60, 60]
        tubes[1, 1, :] = box(T - 1)
        return tubes, np.full((L, P), 0.5, np.float32), {"stride": stride}
    return make


def _second_actor(k, suppress):
    def make():
        L, P, T = 2, 3, 4
        tubes = np.zeros((L, P, T, 4), np.float32)
        tubes[:, 0] = [10, 10, 30, 30]
        tubes[:, 1] = [11, 11, 31, 31]
        tubes[:, 2] = [60, 60, 80, 80]
        scores = np.broadcast_to(np.float32([0.9, 0.8, 0.5]), (L, P)).copy()
        return tubes, scores, {"k": k, "suppress_iou": suppress}
    return make


def _exhausted_clip():
    L, P, T = 3, 2, 4
    tubes = np.zeros((L, P, T, 4), np.float32)
    tubes[:, 0] = [10, 10, 30, 30]
    tubes[0, 1] = [60, 60, 80, 80]
    tubes[2, 1] = [60, 60, 80, 80]
    tubes[1, 1] = [11, 11, 31, 31]
    scores = np.float32([[0.9, 0.6], [0.9, 0.55], [0.9, 0.6]])
    return tubes, scores, {"k": 2, "suppress_iou": 0.5}


def _two_actors():
    L, P, T = 8, 5, 4
    rng = np.random.RandomState(0)
    tubes = rng.rand(L, P, T, 4).astype(np.float32) * 20
    tubes[..., 2:] += tubes[..., :2] + 60
    scores = np.full((L, P), 0.01, np.float32)
    for l in range(L):
        tubes[l, 0] = _tube([10 + 5 * l, 10, 30 + 5 * l, 30], T)
        scores[l, 0] = 0.9
        tubes[l, 1] = _tube([60, 10 + 5 * l, 80, 30 + 5 * l], T)
        scores[l, 1] = 0.8 if 2 <= l <= 4 else 0.02
    return tubes, scores, {"link_iou_weight": 0.5, "k": 2, "trim_thresh": 0.1}


def _node_disjoint():
    rng = np.random.RandomState(3)
    return (_random_tubes(rng, 4, 6, 2, 50.0, 5.0),
            rng.rand(4, 6).astype(np.float32), {"k": 3})


def _exhaustion_guard():
    rng = np.random.RandomState(6)
    tubes = _random_tubes(rng, 3, 4, 2)
    scores = rng.rand(3, 4).astype(np.float32) + 0.2
    valid = np.zeros((3, 4), np.float32)
    valid[:, :2] = 1.0
    return tubes, scores, {"valid": valid, "k": 4, "trim_thresh": 0.1}


def _ties():
    """Identical tubes (every IoU ties) and scores on a coarse grid (many
    equal candidates): the first maximal index must win everywhere."""
    rng = np.random.RandomState(7)
    L, P, T = 6, 5, 3
    tubes = np.broadcast_to(np.float32([10, 10, 50, 50]), (L, P, T, 4)).copy()
    tubes[:, 3] = [12, 10, 52, 50]                # a second, tied IoU level
    scores = (rng.randint(0, 3, (L, P)) / 4.0).astype(np.float32)
    return tubes, scores, {"k": 3, "stride": 1, "suppress_iou": 0.99}


def _nan_scores():
    rng = np.random.RandomState(8)
    L, P, T = 5, 4, 3
    scores = rng.rand(L, P).astype(np.float32)
    scores[1, 2] = np.nan
    scores[3, [0, 3]] = np.nan
    return _random_tubes(rng, L, P, T), scores, {"k": 2}


def _random_masked(stride):
    def make():
        rng = np.random.RandomState(9)
        L, P, T = 7, 6, 4
        valid = (rng.rand(L, P) > 0.3).astype(np.float32)
        cmask = np.float32([1, 1, 1, 1, 1, 0, 0])
        return (_random_tubes(rng, L, P, T), rng.rand(L, P).astype(np.float32),
                {"valid": valid, "k": 3, "clip_mask": cmask, "stride": stride,
                 "suppress_iou": 0.3})
    return make


K_CASES = {
    "continuity": _continuity,
    "stride_aligned": _stride_aligned(2),
    "stride_legacy": _stride_aligned(None),
    "stride_T_falls_back": _stride_aligned(4),
    "second_actor_plain": _second_actor(2, None),
    "second_actor_suppressed": _second_actor(2, 0.5),
    "second_actor_exhausted": _second_actor(3, 0.5),
    "exhausted_clip": _exhausted_clip,
    "two_actors_trimmed": _two_actors,
    "node_disjoint": _node_disjoint,
    "exhaustion_guard": _exhaustion_guard,
    "ties": _ties,
    "nan_scores": _nan_scores,
    "masked_aligned": _random_masked(2),
    "masked_legacy": _random_masked(None),
}


def _jax_args(tubes, scores, kw):
    conv = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return jnp.asarray(tubes), jnp.asarray(scores), conv


def _torch_args(tubes, scores, kw):
    conv = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}
    return torch.from_numpy(tubes), torch.from_numpy(scores), conv


def _assert_link_equal(got, want):
    for key in ("paths", "trim"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("values", "tube_scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=VALUE_TOL, err_msg=key)


@pytest.mark.parametrize("case", sorted(K_CASES))
def test_link_tubes_k_matches_jax(case):
    tubes, scores, kw = K_CASES[case]()
    jt, js, jkw = _jax_args(tubes, scores, kw)
    want = jax_link_tubes_k(jt, js, **jkw)
    t, s, tkw = _torch_args(tubes, scores, kw)
    got = tl.link_tubes_k(t, s, **tkw)
    assert got["paths"].dtype == torch.int32
    _assert_link_equal(got, want)
    paths, trim = got["paths"].numpy(), got["trim"].numpy()
    for l in range(paths.shape[1]):        # emitted nodes are disjoint per clip
        emitted = paths[trim[:, l] > 0, l]
        assert len(set(emitted)) == len(emitted), (case, l)
    if "clip_mask" in kw:                  # padded clips never emitted
        assert trim[:, kw["clip_mask"] == 0].sum() == 0


@pytest.mark.parametrize("case", ["continuity", "stride_aligned", "ties",
                                  "nan_scores", "stride_legacy"])
def test_link_tubes_matches_jax(case):
    tubes, scores, kw = K_CASES[case]()
    kw = {k: v for k, v in kw.items() if k in ("valid", "link_iou_weight", "stride")}
    jt, js, jkw = _jax_args(tubes, scores, kw)
    want_path, want_value = jax_link_tubes(jt, js, **jkw)
    t, s, tkw = _torch_args(tubes, scores, kw)
    path, value = tl.link_tubes(t, s, **tkw)
    np.testing.assert_array_equal(path.numpy(), np.asarray(want_path))
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=1e-6)


@pytest.mark.parametrize("stride", [None, 2])
def test_multiclass_linking_matches_jax(stride):
    rng = np.random.RandomState(10)
    L, P, T, C = 6, 5, 4, 3
    tubes = _random_tubes(rng, L, P, T)
    cls = rng.rand(L, P, C).astype(np.float32)
    valid = np.ones((L, P), np.float32)
    valid[:, -1] = 0.0
    cmask = np.float32([1, 1, 1, 1, 0, 0])
    want = jax_multiclass_k(
        jnp.asarray(tubes), jnp.asarray(cls), jnp.asarray(valid), k=3,
        clip_mask=jnp.asarray(cmask), stride=stride, suppress_iou=0.5)
    got = tl.link_tubes_multiclass_k(
        torch.from_numpy(tubes), torch.from_numpy(cls), torch.from_numpy(valid),
        1.0, 3, 0.05, torch.from_numpy(cmask), stride=stride, suppress_iou=0.5)
    assert got["paths"].shape == (C, 3, L)
    _assert_link_equal(got, want)
    want_p, want_v = jax_multiclass(jnp.asarray(tubes), jnp.asarray(cls),
                                    jnp.asarray(valid), stride=stride)
    got_p, got_v = tl.link_tubes_multiclass(torch.from_numpy(tubes),
                                            torch.from_numpy(cls),
                                            torch.from_numpy(valid), stride=stride)
    assert got_p.shape == (C, L)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6)


def test_clip_mask_padding_keeps_the_real_prefix():
    rng = np.random.RandomState(4)
    L, P, T, Lb = 5, 4, 3, 8
    tubes = _random_tubes(rng, L, P, T, 40.0, 10.0)
    scores = rng.rand(L, P).astype(np.float32)
    ref = tl.link_tubes_k(torch.from_numpy(tubes), torch.from_numpy(scores), k=2,
                          trim_thresh=0.1)
    tubes_p = np.concatenate([tubes, np.repeat(tubes[-1:], Lb - L, 0)])
    scores_p = np.concatenate([scores, np.repeat(scores[-1:], Lb - L, 0)])
    cmask = np.zeros(Lb, np.float32)
    cmask[:L] = 1
    out = tl.link_tubes_k(torch.from_numpy(tubes_p), torch.from_numpy(scores_p), k=2,
                          trim_thresh=0.1, clip_mask=torch.from_numpy(cmask))
    want = jax_link_tubes_k(jnp.asarray(tubes_p), jnp.asarray(scores_p), k=2,
                            trim_thresh=0.1, clip_mask=jnp.asarray(cmask))
    _assert_link_equal(out, want)
    np.testing.assert_array_equal(out["trim"][:, :L].numpy(), ref["trim"].numpy())
    for k in range(2):
        act = ref["trim"][k] > 0
        np.testing.assert_array_equal(out["paths"][k, :L][act].numpy(),
                                      ref["paths"][k][act].numpy())
    assert float(out["trim"][:, L:].sum()) == 0.0


@pytest.mark.parametrize("x", [
    [-1.0, 2.0, 3.0, -1.0, 1.0, -5.0],
    [-3.0, -0.5, -2.0],                      # all negative: the largest element
    [-2.0, -2.0, -2.0],                      # all negative and tied: the first
    [1.0, -1.0, 1.0, -1.0, 1.0],             # ties between runs
    [-1e6, 0.25, -1e6, -1e6],                # DEAD slots around one live clip
    [-1e6, -1e6],                            # nothing alive
])
def test_max_subarray_mask_matches_jax(x):
    x = np.float32(x)
    want_mask, want_best = jax_max_subarray_mask(jnp.asarray(x))
    mask, best = tl.max_subarray_mask(torch.from_numpy(x))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert float(best) == float(want_best)
    # batched over leading axes: each row as alone
    rows = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    bmask, bbest = tl.max_subarray_mask(rows)
    np.testing.assert_array_equal(bmask[0].numpy(), mask.numpy())
    np.testing.assert_array_equal(bmask[1].numpy(),
                                  tl.max_subarray_mask(rows[1])[0].numpy())


@pytest.mark.parametrize("row", [
    [0.5, 0.5, 0.2],
    [0.1, np.nan, 0.9, np.nan],
    [np.nan, np.nan],
    [-np.inf, -np.inf, -1e9],
    [3.0, 3.0, 3.0, 3.0],
])
def test_argmax_rules_match_jax(row):
    """`torch.max(dim)` picks what `jnp.argmax` picks: the first maximum,
    and the first NaN when there is one."""
    x = np.float32([row, row[::-1]])
    for axis in (0, 1):
        values, idx = torch.max(torch.from_numpy(x), dim=axis)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jnp.argmax(jnp.asarray(x), axis)))
        np.testing.assert_array_equal(values.numpy(), np.asarray(jnp.max(jnp.asarray(x), axis)))
