"""K10's plain versions (``delphi_tpu_torch/ops/kernels/linear.py``)
against the JAX package on the CPU, with numpy-seeded inputs:

* K10c (``adam_step_plain``) fed the same gradients as ``optax.adam``
  under ``jax.jit``: parameters and moments bit for bit after every one
  of 300 steps;
* K10a's loss and ``dlogits`` and K10b's gradients against
  ``jax.value_and_grad`` of the JAX package's gather objective, and K10b
  against ``torch.autograd`` on the plain forward;
* the port's gather fit against the JAX package's at 1, 5 and 100 steps;
* the kernels' summation orders (the warp butterfly with its stack of
  class chunks, the tiles and levels of the tree sums) emulated in
  Python, equal to the plain versions' bit for bit;
* ``chip_smoke.LOGREG_EDGES``' ring corners and kernel routes, and those
  shapes through the plain versions against the JAX objective;
* a fresh process's logistic and MLP fits leave ``torch._dynamo``
  unimported.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import chip_smoke
from delphi_tpu.models import encoding as j_enc
from delphi_tpu.models import linear as j_lin
from delphi_tpu_torch import set_device
from delphi_tpu_torch.models import encoding as t_enc
from delphi_tpu_torch.models import linear as t_lin
from delphi_tpu_torch.ops.kernels import build
from delphi_tpu_torch.ops.kernels import linear as k_lin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    # one intra-op thread: the CPU kernels' reduction order follows the
    # thread count, and the test workers share the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_device(None)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# -- K10c ---------------------------------------------------------------------


@pytest.mark.parametrize("lr", [0.2, 0.01])
def test_adam_plain_matches_optax_bitwise(lr):
    """300 steps of gradients over 24 decades, zeros and -0.0: the plain
    step's parameters, mu and nu equal optax.adam's under jax.jit on the
    CPU bit for bit after every step (XLA's order of the update, and the
    bias corrections of ``bias_corrections``)."""
    rng = np.random.default_rng(0)
    n, steps = 3000, 300
    grads = (rng.standard_normal((steps, n))
             * np.exp(rng.uniform(-20, 3, (steps, n)))).astype(np.float32)
    grads[:, :10] = 0.0
    grads[::7, 10:20] = -0.0
    opt = optax.adam(lr)

    @jax.jit
    def jstep(p, s, g):
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s

    jp = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    js = opt.init(jp)
    p = torch.from_numpy(np.array(jp))
    mu, nu = torch.zeros(n), torch.zeros(n)
    before = dict(k_lin.launches)
    for t in range(1, steps + 1):
        jp, js = jstep(jp, js, jnp.asarray(grads[t - 1]))
        k_lin.adam_step(p, torch.from_numpy(grads[t - 1]), mu, nu, lr, t)
        np.testing.assert_array_equal(_bits(p.numpy()), _bits(jp),
                                      err_msg=f"step {t}")
        np.testing.assert_array_equal(_bits(mu.numpy()), _bits(js[0].mu))
        np.testing.assert_array_equal(_bits(nu.numpy()), _bits(js[0].nu))
    # a CPU tensor takes the plain version: nothing launched
    assert k_lin.launches == before


def test_bias_corrections_match_xla():
    """optax's ``1 - b ** count`` as XLA:CPU computes it (an int32 count
    converted to f32, f32 pow) equals the host rule for every step up to
    5,000 and beyond."""
    jb = jax.jit(lambda c: (1 - 0.9 ** c, 1 - 0.999 ** c))
    for t in list(range(1, 5001)) + [65_536, 1_000_003]:
        a1, a2 = jb(jnp.int32(t))
        assert k_lin.bias_corrections(t) == (float(a1), float(a2)), t


# -- K10a and K10b ------------------------------------------------------------


def _problem(k, C, n=700, vocab=(9, 5, 13), seed=0):
    """A random gather problem: ids of three features, ``C`` continuous
    columns, labels in the first k - 3 classes (the rest padded, weight
    0), balanced weights, random weights in a range where the softmax is
    neither flat nor one-hot."""
    rng = np.random.default_rng(seed + k + 7 * C)
    offsets = np.concatenate([[0], np.cumsum(vocab[:-1])])
    gid = (offsets + np.stack([rng.integers(0, v, n) for v in vocab], 1)) \
        .astype(np.int64)
    V = int(sum(vocab))
    real = max(k - 3, 1)
    y = rng.integers(0, real, n).astype(np.int64)
    counts = np.bincount(y, minlength=k).astype(np.float32)
    cw = np.zeros(k, np.float32)
    cw[:real] = j_enc.balanced_class_weights(counts[:real], n, damped=False)
    sw = cw[y]
    return {"gid": gid, "cont": rng.standard_normal((n, C)).astype(np.float32),
            "y": y, "sw": sw, "cw": cw, "V": V, "k": k, "l2": 1e-3,
            "Wcat": (rng.standard_normal((V, k)) * 0.5).astype(np.float32),
            "Wcont": (rng.standard_normal((C, k)) * 0.5).astype(np.float32),
            "b": (rng.standard_normal(k) * 0.5).astype(np.float32),
            "denom": max(float(k_lin.tree_sum(torch.from_numpy(sw))), 1.0)}


def _jax_objective(P):
    """The JAX package's gather loss (``_fit_logreg_gather``'s loss_fn,
    without padding: every feature and row real) and the logits it
    differentiates."""
    gid, cont, y = jnp.asarray(P["gid"]), jnp.asarray(P["cont"]), \
        jnp.asarray(P["y"])
    sw, denom, l2 = jnp.asarray(P["sw"]), jnp.float32(P["denom"]), P["l2"]

    def logits_of(params):
        Wcat, Wcont, b = params
        return Wcat[gid].sum(axis=1) + cont @ Wcont + b

    def nll(logits):
        logp = jax.nn.log_softmax(logits, axis=-1)
        return (sw * -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]) \
            .sum() / denom

    def loss(params):
        Wcat, Wcont, _ = params
        return nll(logits_of(params)) \
            + l2 * (jnp.sum(Wcat * Wcat) + jnp.sum(Wcont * Wcont))

    params = (jnp.asarray(P["Wcat"]), jnp.asarray(P["Wcont"]),
              jnp.asarray(P["b"]))
    value, grads = jax.value_and_grad(loss)(params)
    dlogits = jax.grad(nll)(logits_of(params))
    return float(value), np.asarray(dlogits), [np.asarray(g) for g in grads]


def _plain(P):
    t = {name: torch.from_numpy(np.asarray(P[name]))
         for name in ("gid", "cont", "y", "sw", "Wcat", "Wcont", "b")}
    plan = k_lin.gather_plan(t["gid"], t["cont"], t["y"], t["sw"],
                             P["denom"], P["l2"], P["V"], P["k"])
    loss = torch.empty(1)
    dlogits = torch.empty((len(P["y"]), P["k"]))
    k_lin.logreg_forward(plan, t["Wcat"], t["Wcont"], t["b"], loss, dlogits)
    grads = [torch.empty_like(t[name]) for name in ("Wcat", "Wcont", "b")]
    k_lin.logreg_backward(plan, dlogits, t["Wcat"], t["Wcont"], *grads)
    return float(loss[0]), dlogits.numpy(), [g.numpy() for g in grads], t


@pytest.mark.parametrize("C", [0, 2])
@pytest.mark.parametrize("k", [8, 40, 1024])
def test_forward_plain_matches_jax(k, C):
    """K10a's loss within 2e-6 relative of the JAX objective's and its
    dlogits within 1e-8 absolute (about 1e-4 of their largest entry, 1 /
    denom): the two sum the same f32 terms in other orders, and K10a's
    exponentials are f64 ones rounded to f32."""
    P = _problem(k, C)
    want_loss, want_dl, _ = _jax_objective(P)
    loss, dl, _, _ = _plain(P)
    assert loss == pytest.approx(want_loss, rel=2e-6)
    np.testing.assert_allclose(dl, want_dl, rtol=0, atol=1e-8)


@pytest.mark.parametrize("C", [0, 2])
@pytest.mark.parametrize("k", [8, 40, 1024])
def test_backward_plain_matches_jax_and_autograd(k, C):
    """K10b's gradients within 1e-7 absolute of ``jax.value_and_grad``'s
    (their entries are at most about 1e-2: sums of up to 700 dlogits in
    another order) and of ``torch.autograd`` through a plain forward (the
    logits as tensor ops, ``log_softmax``) on the same inputs."""
    P = _problem(k, C)
    _, _, want = _jax_objective(P)
    _, _, got, t = _plain(P)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
    leaves = [t[name].clone().requires_grad_()
              for name in ("Wcat", "Wcont", "b")]
    Wcat, Wcont, b = leaves
    logits = Wcat[t["gid"]].sum(1) + t["cont"] @ Wcont + b
    logp = torch.log_softmax(logits, dim=-1)
    loss = (t["sw"] * -logp.gather(1, t["y"][:, None])[:, 0]).sum() \
        / P["denom"] + P["l2"] * ((Wcat * Wcat).sum() + (Wcont * Wcont).sum())
    for g, w in zip(got, torch.autograd.grad(loss, leaves)):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-7)


def test_unseen_id_gets_only_its_l2_term():
    """An id that no row holds: its gradient is exactly 2 l2 W (as t +
    t); the others hold their occurrences' sums."""
    P = _problem(8, 1, n=50, vocab=(6, 4))
    P["gid"][P["gid"] == 2] = 3
    _, _, (gW, _, _), t = _plain(P)
    l2w = np.float32(P["l2"]) * P["Wcat"][2]
    np.testing.assert_array_equal(gW[2], l2w + l2w)


# -- the whole gather fit -----------------------------------------------------


def _frame(k, seed, n=1200):
    rng = np.random.default_rng(seed)
    latent = rng.integers(0, k, n)
    df = pd.DataFrame({
        "a": [f"a{v}" for v in latent],
        "b": [f"b{v % 7}" for v in latent + rng.integers(0, 2, n)],
        "c": [f"c{v}" for v in rng.integers(0, 5, n)],
        "x": latent * 0.5 + rng.normal(0, 1, n),
    })
    df.loc[rng.random(n) < 0.1, "a"] = None
    y = np.where(rng.random(n) < 0.03, rng.integers(0, k, n), latent)
    return df, pd.Series([f"y{v}" for v in y])


def _compact(enc_mod, df):
    return enc_mod.FeatureEncoder(["a", "b", "c", "x"], ["x"]) \
        .fit_transform_compact(df)


@pytest.mark.parametrize("n_steps", [1, 5, 100])
def test_gather_fit_matches_jax(n_steps):
    """The port's gather fit (K10a, K10b, K10c) against the JAX package's
    ``_fit_logreg_gather`` at 1, 5 and 100 steps: the same steps taken,
    probabilities within 1e-4 (as ``tests/test_torch_linear.py`` holds
    them; they come out within about 1e-6), the last loss within 1e-4
    relative, and the same class wherever the JAX package's top two
    probabilities are more than 1e-5 apart (every row at 100 steps):
    after one or five sign-like Adam steps from zero many rows' logits
    tie exactly, and a tie falls by an ulp. 30 classes (32 padded): with
    as many classes as padded ones, a balanced bias gradient is zero up
    to rounding at the start, and Adam's first steps, normalized, turn
    that rounding into moves of the learning rate in either package."""
    df, y = _frame(30, 3)
    jm = j_lin.LogisticRegressionModel(n_steps=n_steps).fit(
        _compact(j_enc, df), y)
    tm = t_lin.LogisticRegressionModel(n_steps=n_steps).fit(
        _compact(t_enc, df), y)
    assert tm._compact is not None and tm.n_steps_run_ == n_steps
    test_df, _ = _frame(30, 103, n=600)
    Xj, Xt = _compact(j_enc, test_df), _compact(t_enc, test_df)
    pj, pt = jm.predict_proba(Xj), tm.predict_proba(Xt)
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    top2 = np.sort(pj, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    if n_steps == 100:
        assert clear.all()
    assert clear.sum() > 0
    np.testing.assert_array_equal(tm.predict(Xt)[clear], jm.predict(Xj)[clear])
    np.testing.assert_allclose(tm.loss_, jm.loss_, rtol=1e-4)


def test_gather_fit_without_continuous_columns():
    """C = 0 (no continuous column): the fit runs and matches the JAX
    package's (which pads to eight zero columns) as above."""
    df, y = _frame(30, 4)
    enc = lambda m: m.FeatureEncoder(["a", "b", "c"], []) \
        .fit_transform_compact(df)  # noqa: E731
    jm = j_lin.LogisticRegressionModel(n_steps=60).fit(enc(j_enc), y)
    tm = t_lin.LogisticRegressionModel(n_steps=60).fit(enc(t_enc), y)
    assert tm._params[1].shape == (0, 32)
    np.testing.assert_allclose(tm.predict_proba(enc(t_enc)),
                               jm.predict_proba(enc(j_enc)), atol=1e-4,
                               rtol=0)


# -- the kernels' orders, emulated --------------------------------------------


def _f32(x):
    return np.float32(x)


def _warp_halving(vals):
    """A warp's shuffle tree: lane i < s adds lane i + s."""
    v = [_f32(x) for x in vals]
    s = 16
    while s:
        v = [v[i] + v[i + s] if i < s else v[i] for i in range(32)]
        s //= 2
    return v[0]


def _warp_pairwise(vals):
    """A warp's butterfly: every lane adds lane i ^ s, s = 1 .. 16."""
    v = [_f32(x) for x in vals]
    s = 1
    while s < 32:
        v = [v[i] + v[i ^ s] for i in range(32)]
        s *= 2
    return v[0]


def _kernel_class_sum(e):
    """K10a's class tree: each 32-class chunk's butterfly (zeros past k),
    the chunks' sums merged as a binary counter, the stack folded from
    the top (the rows kernel). The wave kernel's lanes butterfly over at
    most 8 chunk sums and zeros is the same adjacent-pair tree."""
    stack, chunks = [], 0
    for c0 in range(0, len(e), 32):
        chunk = list(e[c0:c0 + 32]) + [0.0] * (32 - len(e[c0:c0 + 32]))
        v = _warp_pairwise(chunk)
        j = chunks
        while j & 1:
            v = stack.pop() + v
            j >>= 1
        stack.append(v)
        chunks += 1
    z = stack.pop()
    while stack:
        z = stack.pop() + z
    return z


def _kernel_tree(x, first_levels):
    """tree_sum as the kernels take it: blocks of 32 ** first_levels
    values each reduced through that many warp levels, then the tail's
    rounds of 32-tiles until one value is left."""
    block = 32 ** first_levels
    parts = []
    for b0 in range(0, max(len(x), 1), block):
        v = list(x[b0:b0 + block]) + [0.0] * (block - len(x[b0:b0 + block]))
        for _ in range(first_levels):
            v = [_warp_halving(v[i:i + 32]) for i in range(0, len(v), 32)]
        parts.append(v[0])
    while len(parts) > 1:
        parts = [_warp_halving(parts[i:i + 32]
                               + [0.0] * (32 - len(parts[i:i + 32])))
                 for i in range(0, len(parts), 32)]
    return parts[0]


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 1941, 2048, 10_000, 40_000])
def test_xla_sum_matches_jax_bitwise(n):
    """K10b's row sums (``xla_sum``) equal the JAX package's reductions
    under ``jax.jit`` on the CPU bit for bit, along the rows of a 2-D
    array and of a 1-D one."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 40))
         * np.exp(rng.uniform(-8, 8, (n, 40)))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a.sum(axis=0))(x))
    np.testing.assert_array_equal(
        _bits(k_lin.xla_sum(torch.from_numpy(x).T).numpy()), _bits(want))
    want1 = np.asarray(jax.jit(lambda a: a.sum())(x[:, 0]))
    assert _bits(k_lin.xla_sum(torch.from_numpy(x[:, 0]))) == _bits(want1)


def _kernel_xla_sum(x):
    """K10b's row sum as its blocks take it: 32-row windows from
    ``front`` (one block each; with at most 32 rows, one block sums them
    all), then the last block's rounds of windows of 32 window sums,
    each from its ``lead``, skipping the padding, and the last at most
    32 sums in order."""
    def window_sum(vals, start, count):
        acc = _f32(0.0)
        for i in range(32):
            if 0 <= start + i < count:
                acc = acc + vals[start + i]
        return acc
    n = len(x)
    if n <= 32:
        acc = _f32(0.0)
        for v in x:
            acc = acc + _f32(v)
        return acc
    tiles = -(-n // 32)
    front = (tiles * 32 - n) // 2
    parts = [window_sum(x, t * 32 - front, n) for t in range(tiles)]
    while len(parts) > 32:
        groups = -(-len(parts) // 32)
        lead = (groups * 32 - len(parts)) // 2
        parts = [window_sum(parts, q * 32 - lead, len(parts))
                 for q in range(groups)]
    acc = _f32(0.0)
    for v in parts:
        acc = acc + v
    return acc


@pytest.mark.parametrize("n", [1, 32, 33, 700, 1941, 40_000])
def test_xla_sum_equals_kernel_order(n):
    rng = np.random.default_rng(n + 1)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-10, 10, n))) \
        .astype(np.float32)
    x[::5] = -0.0
    want = float(k_lin.xla_sum(torch.from_numpy(x)))
    assert _f32(want) == _kernel_xla_sum([_f32(v) for v in x])


@pytest.mark.parametrize("k", [1, 7, 8, 32, 33, 40, 72, 96, 1000, 1024,
                               1056, 33_000, 65_536])
def test_class_tree_equals_kernel_order(k):
    rng = np.random.default_rng(k)
    e = np.exp(rng.uniform(-30, 0, k)).astype(np.float32)
    e[rng.integers(0, k)] = 1.0
    want = float(k_lin.pairwise_sum(torch.from_numpy(e)[None])[0])
    assert _f32(want) == _kernel_class_sum(e)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 700, 1024, 1025, 40_000])
@pytest.mark.parametrize("first_levels", [1, 2])
def test_tree_sum_equals_kernel_order(n, first_levels):
    """Both first stages K10a uses (its row blocks: one level; its weight
    blocks: two) give tree_sum's bits, non-negative summands of mixed
    magnitudes."""
    rng = np.random.default_rng(n)
    x = (rng.random(n) * np.exp(rng.uniform(-10, 10, n))).astype(np.float32)
    want = float(k_lin.tree_sum(torch.from_numpy(x)))
    assert _f32(want) == _kernel_tree(x, first_levels)


def test_ctypes_layouts():
    """The parameter tables' sizes equal the CUDA structs' (static_asserts
    in ``csrc/linear.cu``)."""
    import ctypes
    assert ctypes.sizeof(k_lin.ForwardParams) == 136
    assert ctypes.sizeof(k_lin.BackwardParams) == 112
    assert ctypes.sizeof(k_lin.AdamParams) == 72


# -- the card's edge shapes ----------------------------------------------------


def test_logreg_edges_reach_the_ring_corners():
    """``chip_smoke.LOGREG_EDGES`` holds the corners of K10b's ring and
    class groups: a chain of more than 20,000 occurrences (the ring
    wrapping many times), k 41 and 2 (a last group of 1 and 2 of its 8
    classes), ids of exactly ``RING_STAGE`` occurrences and one less and
    one more, and 20,000 ids of a few occurrences each at k 8."""
    chains, ks, stage = [], set(), None
    for shape in chip_smoke.LOGREG_EDGES:
        t = chip_smoke.logreg_edge_inputs(shape, sum(shape[:5]))
        lengths = np.bincount(t["gid"].numpy().reshape(-1),
                              minlength=t["V"])
        chains.append((shape, int(lengths.max())))
        ks.add(t["k"])
        if shape[-1] == "stage":
            stage = lengths[:3].tolist()
    assert max(c for _, c in chains) > 20_000
    assert {41 % 8, 2 % 8} <= {k % 8 for k in ks}
    s = k_lin.RING_STAGE
    assert stage == [s, s - 1, s + 1]
    assert any(shape[3] >= 20_000 and shape[4] == 8 and c < 20
               for shape, c in chains)


def test_logreg_edges_reach_every_kernel_route():
    """``chip_smoke.LOGREG_EDGES`` drives every route of K10a and K10b
    that ``delphi_logreg_forward`` / ``delphi_logreg_backward`` choose
    (the constants mirrored in ``ops/kernels/linear.py`` equal
    ``csrc/linear.cu``'s): K10a's wave kernel with 2 register chunks, its
    weights staged and not, and with 8 staged; its rows kernel at 200
    classes with the weights not staged and past 256 classes, its class
    stack past 1,024 chunks; K10b's ring and its block an id, that one
    over more than one stage of 1,024 occurrence rows."""
    import re
    src = open([s for s in build.sources() if s.endswith("linear.cu")][0]).read()

    def const(name):
        return int(eval(re.search(rf"constexpr int {name} = ([^;]+);",
                                  src).group(1)))
    assert const("kStageFloats") // const("kGroup") == k_lin.RING_STAGE
    assert const("kWideClasses") == k_lin.WIDE_CLASSES
    assert const("kWeightSmem") == k_lin.WEIGHT_SMEM
    forward, backward = set(), set()
    for shape in chip_smoke.LOGREG_EDGES:
        n, F, C, V, k, kind = shape
        chunks = -(-k // 32)
        staged = (V + C + 1) * k * 4 <= k_lin.WEIGHT_SMEM
        if chunks <= 2:
            forward.add(("wave 2", staged))
        elif chunks <= 8 and staged:
            forward.add(("wave 8", True))
        else:
            forward.add(("rows", "past 1,024 chunks" if chunks > 1024
                         else "past 256" if chunks > 8 else "not staged"))
        t = chip_smoke.logreg_edge_inputs(shape, sum(shape[:5]))
        chain = int(np.bincount(t["gid"].numpy().reshape(-1)).max())
        backward.add("ring" if k < k_lin.WIDE_CLASSES
                     else "id, several stages" if chain > 1024 else "id")
    assert forward == {("wave 2", True), ("wave 2", False), ("wave 8", True),
                       ("rows", "not staged"), ("rows", "past 256"),
                       ("rows", "past 1,024 chunks")}
    assert backward == {"ring", "id", "id, several stages"}


@pytest.mark.parametrize("shape", chip_smoke.LOGREG_EDGES[8:])
def test_logreg_edges_plain_match_jax(shape):
    """The card's ring-corner edge inputs (rows cut to 2,000) through the
    plain forward and backward agree with the JAX package's gather objective
    within ``test_forward_plain_matches_jax``'s and
    ``test_backward_plain_matches_jax_and_autograd``'s tolerances: the
    edges the card holds its kernels to are the reference's answers too."""
    n, F, C, V, k, kind = shape
    t = chip_smoke.logreg_edge_inputs((min(n, 2_000), F, C, V, k, kind),
                                      sum(shape[:5]))
    P = {"gid": t["gid"].numpy(), "cont": t["cont"].numpy(),
         "y": t["y"].numpy(), "sw": t["sample_w"].numpy(),
         "Wcat": t["Wcat"].numpy(), "Wcont": t["Wcont"].numpy(),
         "b": t["b"].numpy(), "denom": t["denom"], "l2": t["l2"],
         "V": V, "k": k}
    want_loss, want_dl, want_grads = _jax_objective(P)
    loss, dl, grads, _ = _plain(P)
    assert loss == pytest.approx(want_loss, rel=2e-6)
    np.testing.assert_allclose(dl, want_dl, rtol=0, atol=1e-8)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)


# -- no torch.optim, no torch._dynamo -----------------------------------------


def test_fresh_process_fits_leave_dynamo_unimported():
    """A fresh CPU process fits the logistic head (gather route) and the
    MLP: neither imports ``torch._dynamo``, which the first
    ``torch.optim`` optimizer of a process pulls in (seconds)."""
    script = (
        "import sys, numpy as np, pandas as pd\n"
        "from delphi_tpu_torch.models.encoding import FeatureEncoder\n"
        "from delphi_tpu_torch.models.linear import (LogisticRegressionModel,"
        " MLPRegressorModel)\n"
        "rng = np.random.default_rng(0)\n"
        "df = pd.DataFrame({'a': [f'a{v}' for v in rng.integers(0, 9, 300)],"
        " 'x': rng.normal(size=300)})\n"
        "y = pd.Series([f'y{v}' for v in rng.integers(0, 30, 300)])\n"
        "X = FeatureEncoder(['a', 'x'], ['x']).fit_transform_compact(df)\n"
        "m = LogisticRegressionModel(n_steps=30).fit(X, y)\n"
        "assert m._compact is not None and m.n_steps_run_ == 30\n"
        "Xd = FeatureEncoder(['a', 'x'], ['x']).fit_transform(df)\n"
        "MLPRegressorModel(n_steps=30).fit(Xd, pd.Series(rng.normal(size=300)))\n"
        "print('dynamo' if 'torch._dynamo' in sys.modules else 'clean')\n")
    env = dict(os.environ, DELPHI_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "clean"
