"""Kernel 5' (the EmbeddingBag backward) on the CPU: its plain version
``embedding_bag_backward_ref`` against the JAX package's gradient of
``jnp.take(mode="fill")`` and against torch autograd of
``embedding_bag_ref``, and the autograd routing of ``embedding_bag_sums``
/ ``embedding_bag`` / ``take_rows``.

Inputs are drawn with numpy from a seed.  Tolerances, and why:

* against JAX's scatter-add, with every row at most ``BACKWARD_CHUNK``
  slots: exactly equal (both add a row's contributions in slot order from
  0); with rows cut into chunks (``chunk=`` small), rtol = atol = 1e-5:
  the chunk association differs from one running sum, and a hot row of
  600 normal terms sums to ~25 with ~1e-5 of rounding between orders;
* against torch autograd of ``embedding_bag_ref`` (its index backward adds
  in an order of its own): rtol 1e-6, atol 1e-6.
The association itself is held exactly to an explicit loop over rows and
chunks, since the card holds the kernel to this plain version bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro_torch.kernels import (
    BACKWARD_CHUNK,
    backward_plan,
    backward_sums_ref,
    embedding_bag,
    embedding_bag_backward,
    embedding_bag_backward_ref,
    embedding_bag_plan,
    embedding_bag_ref,
    embedding_bag_sums,
    same_bits,
    take_rows,
)
from repro_torch.kernels.embedding_bag.embedding_bag import _backward_sums

REL = 1e-6
CHUNKED_TOL = 1e-5


def _ids(V, shape, seed, hot=None):
    """int32 ids in [-V, V) with -1, -7, V, V+3, -V-1 (below -V) planted,
    duplicates everywhere, and ``hot`` slots of id 2 when given."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-V, V, shape).astype(np.int32)
    flat = ids.reshape(-1)
    planted = [-1, -7, V, V + 3, -V - 1]
    flat[rng.choice(flat.size, len(planted), replace=False)] = planted
    if hot:
        flat[rng.choice(flat.size, hot, replace=False)] = 2
    return ids


def _jax_take_grad(table, ids, g):
    """d/d table of sum(take(table, ids, fill) * g), in JAX."""
    def f(t):
        return jnp.sum(jnp.take(t, jnp.asarray(ids), axis=0, mode="fill", fill_value=0.0)
                       * jnp.asarray(g))
    return np.asarray(jax.grad(f)(jnp.asarray(table)))


@pytest.mark.parametrize("shape,hot", [((64, 1), None), ((16, 50), None), ((40, 50), 600),
                                       ((3, 7, 11), 40)])
def test_take_rows_gradient_matches_jax(shape, hot):
    """``take_rows`` under ``backward()`` (the plain backward on the CPU)
    against JAX's gradient of ``jnp.take(mode="fill")``: ids in [-V, -1]
    wrap, others out of range add nothing, duplicates and a hot row add."""
    V, D = 37, 6
    rng = np.random.default_rng(len(shape) + (hot or 0))
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = _ids(V, shape, 5, hot)
    g = rng.standard_normal(shape + (D,)).astype(np.float32)
    want = _jax_take_grad(table, ids, g)
    t = torch.from_numpy(table).requires_grad_(True)
    out = take_rows(t, torch.from_numpy(ids))
    assert out.shape == shape + (D,)
    out.backward(torch.from_numpy(g))
    assert np.array_equal(t.grad.numpy(), want)  # every row <= BACKWARD_CHUNK slots
    chunked = embedding_bag_backward_ref(
        torch.from_numpy(g.reshape(-1, D)),
        torch.from_numpy(np.where(ids < 0, ids + V, ids).reshape(-1, 1)), V, chunk=3)
    np.testing.assert_allclose(chunked.numpy(), want, rtol=CHUNKED_TOL, atol=CHUNKED_TOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_gradient_matches_autograd_of_the_plain_forward(weighted, mode):
    """``embedding_bag`` (L > 1, weights, padding) under ``backward()``
    against torch autograd of ``embedding_bag_ref`` itself."""
    V, D, B, L = 29, 5, 23, 9
    rng = np.random.default_rng(7)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = torch.from_numpy(_ids(V, (B, L), 8, hot=30))
    w = torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32)) if weighted else None
    g = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    t = torch.from_numpy(table).requires_grad_(True)
    embedding_bag(t, ids, w, mode=mode).backward(g)
    r = torch.from_numpy(table).requires_grad_(True)
    want = embedding_bag_ref(r, ids, w)
    if mode == "mean":
        want = want / torch.clamp_min((ids >= 0).float().sum(dim=1, keepdim=True), 1)
    want.backward(g)
    torch.testing.assert_close(t.grad, r.grad, rtol=REL, atol=REL)


def _loop_backward(grad_out, ids, V, weights, chunk):
    """The documented association by explicit loops: each row's slots in
    slot order, in chunks of ``chunk`` from its first slot, each chunk
    summed from 0, the row the sum of its chunks from 0 (float32)."""
    B, L = ids.shape
    g = grad_out.numpy()
    w = None if weights is None else weights.numpy()
    out = np.zeros((V, g.shape[1]), np.float32)
    for v in range(V):
        slots = [i for i in range(B * L) if ids.numpy().reshape(-1)[i] == v]
        row = np.zeros(g.shape[1], np.float32)
        for c0 in range(0, len(slots), chunk):
            part = np.zeros(g.shape[1], np.float32)
            for i in slots[c0:c0 + chunk]:
                term = g[i // L] if w is None else g[i // L] * w.reshape(-1)[i]
                part = (part + term).astype(np.float32)
            row = (row + part).astype(np.float32)
        out[v] = row
    return out


@pytest.mark.parametrize("chunk", [1, 3, 4, BACKWARD_CHUNK])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_backward_association_is_the_documented_one(chunk, weighted):
    """Bit for bit the loop above, rows short, exactly a chunk and longer."""
    V, D, B, L = 11, 3, 13, 4
    rng = np.random.default_rng(chunk)
    ids = torch.from_numpy(_ids(V, (B, L), chunk, hot=14))
    g = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32)) if weighted else None
    got = embedding_bag_backward_ref(g, ids, V, w, chunk=chunk)
    assert same_bits(got, torch.from_numpy(_loop_backward(g, ids, V, w, chunk)))


def test_backward_plan_groups_slots_by_row():
    V = 6
    ids = torch.tensor([[3, -1, 3, 9], [0, 3, 3, 5], [3, 3, 3, 0]], dtype=torch.int32)
    order, row_start, chunk_base = backward_plan(ids, V, chunk=2)
    assert row_start.tolist() == [0, 2, 2, 2, 9, 9, 10]
    assert order[:10].tolist() == [4, 11, 0, 2, 5, 6, 8, 9, 10, 7]
    assert chunk_base.tolist() == [0, 0, 0, 0, 4, 4, 4]  # row 3's 7 slots: 4 chunks
    assert {int(x) for x in order[10:]} == {1, 3}          # the padding slots last


def _plan_cases():
    """(name, V, ids) the preparation's contract is pinned on: V at 1 and on
    each side of a power of two (the radix sort's bit count is that of
    V - 1), every slot padding, every slot one id (a row of 768 chunks and
    one slot), ids -1, -7, V, V+3 planted, bags of several ids."""
    rng = np.random.default_rng(11)
    cases = [(f"V={V}", V, rng.integers(-3, V + 4, (257, 3)).astype(np.int32))
             for V in (1, 2, 1023, 1024, 1025, 2 ** 20 - 1, 2 ** 20, 2 ** 20 + 1)]
    cases.append(("all padding", 50, np.array([[-1, -7], [50, 53]], np.int32)))
    cases.append(("one id", 50, np.full((768 * BACKWARD_CHUNK + 1, 1), 7, np.int32)))
    cases.append(("sparse", 2 ** 20, rng.choice(2 ** 20, (40, 2)).astype(np.int32)))
    ids = rng.integers(0, 300, (40, 50)).astype(np.int32)
    ids.flat[rng.choice(ids.size, 4, replace=False)] = [-1, -7, 300, 303]
    cases.append(("planted, L=50", 300, ids))
    return cases


@pytest.mark.parametrize("name,V,ids", _plan_cases(), ids=[c[0] for c in _plan_cases()])
def test_backward_plan_is_numpys_stable_sort_and_searchsorted(name, V, ids):
    """``backward_plan`` against numpy: ``order`` is ``np.argsort(kind=
    "stable")`` of the ids with the padding as V, ``row_start`` is
    ``np.searchsorted`` of 0..V in the sorted keys, ``chunk_base`` the
    exclusive prefix of the rows' chunk counts.  The card's preparation is
    held to ``backward_plan`` bit for bit (on ``order[:row_start[V]]``)."""
    flat = ids.reshape(-1).astype(np.int64)
    key = np.where((flat >= 0) & (flat < V), flat, V)
    want_order = np.argsort(key, kind="stable")
    want_start = np.searchsorted(key[want_order], np.arange(V + 1), side="left")
    count = np.diff(want_start)
    chunks = np.where(count > BACKWARD_CHUNK, -(-count // BACKWARD_CHUNK), 0)
    want_base = np.concatenate([[0], np.cumsum(chunks)])
    order, row_start, chunk_base = backward_plan(torch.from_numpy(ids), V)
    assert order.dtype == row_start.dtype == chunk_base.dtype == torch.int32
    assert np.array_equal(order.numpy(), want_order)
    assert np.array_equal(row_start.numpy(), want_start)
    assert np.array_equal(chunk_base.numpy(), want_base)


def test_plan_wrapper_on_the_cpu_is_backward_plan():
    """``embedding_bag_plan`` on a CPU tensor runs ``backward_plan`` (every
    entry of ``order`` too) and launches nothing."""
    ids = torch.from_numpy(_ids(13, (9, 4), 3, hot=20))
    before = embedding_bag_plan.launches
    got = embedding_bag_plan(ids, 13)
    want = backward_plan(ids, 13)
    assert embedding_bag_plan.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("weighted", [False, True])
def test_sums_wrapper_on_the_cpu_is_the_plain_sums(weighted):
    """``_backward_sums`` on CPU tensors runs ``backward_sums_ref`` on the
    plan's grouping and launches nothing; plan then sums is
    ``embedding_bag_backward_ref`` bit for bit, long rows included."""
    V, D, B, L = 23, 5, 40, 9
    rng = np.random.default_rng(4 + weighted)
    ids = torch.from_numpy(_ids(V, (B, L), 6, hot=300))
    g = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32)) if weighted else None
    want = embedding_bag_backward_ref(g, ids, V, w)
    plan = backward_plan(ids, V)
    before = embedding_bag_backward.launches
    got = _backward_sums(g, *plan, L, w)
    assert embedding_bag_backward.launches == before
    assert same_bits(got, want)
    assert same_bits(backward_sums_ref(g, plan[0], plan[1], L, w), want)
    chunked = backward_sums_ref(g, *backward_plan(ids, V, chunk=7)[:2], L, w, chunk=7)
    assert same_bits(chunked, embedding_bag_backward_ref(g, ids, V, w, chunk=7))


def _mismatched(name, g, plan, L, w):
    """``_backward_sums``'s operands with the one called ``name`` off."""
    order, row_start, chunk_base = plan
    if name == "order short":
        order = order[:-1]
    elif name == "order int64":
        order = order.long()
    elif name == "chunk_base short":
        chunk_base = chunk_base[:-1]
    elif name == "row_start 2-D":
        row_start = row_start[None]
    elif name == "weights (B, L - 1)":
        w = w[:, 1:]
    elif name == "grad_out float64":
        g = g.double()
    return g, order, row_start, chunk_base, L, w


@pytest.mark.parametrize("name", ["order short", "order int64", "chunk_base short",
                                  "row_start 2-D", "weights (B, L - 1)", "grad_out float64"])
def test_sums_wrapper_refuses_a_plan_that_does_not_fit(name):
    """``_backward_sums`` raises on a plan, gradient or weights that do not
    belong to one (B, L) lookup of a table of V rows, and launches nothing."""
    V, D, B, L = 23, 5, 40, 9
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(_ids(V, (B, L), 7, hot=30))
    g = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32))
    before = embedding_bag_backward.launches
    with pytest.raises(ValueError):
        _backward_sums(*_mismatched(name, g, backward_plan(ids, V), L, w))
    assert embedding_bag_backward.launches == before


def test_backward_refuses_more_slots_than_int32_numbers():
    """The slots are numbered in int32: 2**31 of them raise ValueError (an
    expanded view, so nothing that large is allocated)."""
    ids = torch.zeros(1, 1, dtype=torch.int32).expand(2 ** 16, 2 ** 15)
    g = torch.zeros(1, 2).expand(2 ** 16, 2)
    with pytest.raises(ValueError, match="int32"):
        backward_plan(ids, 4)
    with pytest.raises(ValueError, match="int32"):
        embedding_bag_plan(ids, 4)
    with pytest.raises(ValueError, match="int32"):
        embedding_bag_backward(g, ids, 4)


def test_autograd_routes_and_refusals():
    """Gradients flow to the table only; a weights gradient raises
    NotImplementedError, a bfloat16 table's backward TypeError; without a
    gradient asked, no autograd node is made."""
    V, D = 9, 4
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    ids = torch.tensor([[1, 2, -1], [8, 8, 0]], dtype=torch.int32)
    w = torch.tensor([[0.5, 2.0, float("nan")], [1.0, -1.0, 3.0]])
    assert embedding_bag_sums(table, ids, w).grad_fn is None
    t = table.clone().requires_grad_(True)
    out = embedding_bag_sums(t, ids, w)
    assert out.grad_fn is not None
    g = torch.ones(2, D)
    out.backward(g)
    want = embedding_bag_backward(g, ids, V, w)
    assert same_bits(t.grad, want)
    assert bool(torch.isfinite(t.grad).all())  # the NaN weight sits on padding
    ww = w.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError):
        embedding_bag_sums(table, ids, ww).sum().backward()
    tb = table.to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(TypeError, match="float32"):
        take_rows(tb, ids).sum().backward()
    with torch.no_grad():
        assert embedding_bag_sums(t, ids).grad_fn is None
