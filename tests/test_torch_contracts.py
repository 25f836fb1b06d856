"""The port's shape contracts (``chunkflow_tpu_torch/core/contracts.py``)
against the JAX package's.

Every case of ``tests/tools/test_contracts.py`` runs on both packages'
``contract`` and ``Spec`` (the jit case's counterpart on the port is a
decorated function called on CPU tensors of two shapes, and
``check_abstract`` runs on ``meta`` tensors); the error texts are the
JAX ones, word for word; the nine decorated entry points of the blend
stack accept what the JAX entry points accept, on the same seeded
inputs, and refuse what they refuse, with the same text. JAX is
imported only inside the cases that compare with it.
"""
import importlib

import numpy as np
import pytest
import torch

from chunkflow_tpu_torch.core import contracts
from chunkflow_tpu_torch.core.contracts import (
    ContractError,
    Spec,
    check_abstract,
    contract,
)
from chunkflow_tpu_torch.ops import accumulate

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

PACKAGES = ("jax", "port")


def _mod(pkg: str, name: str):
    """``chunkflow_tpu.<name>`` or ``chunkflow_tpu_torch.<name>``."""
    root = "chunkflow_tpu" if pkg == "jax" else "chunkflow_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def _arr(pkg: str, shape, dtype=np.float32):
    """Ones of ``shape``: a numpy array for the JAX package, a CPU tensor
    for the port."""
    a = np.ones(shape, dtype)
    return a if pkg == "jax" else torch.from_numpy(a)


def _fake_normalize(pkg):
    c = _mod(pkg, "core.contracts")

    @c.contract(
        out=c.Spec("co", "z", "y", "x", dtype="float32"),
        weight=c.Spec("z", "y", "x", dtype="float32"),
    )
    def fake_normalize(out, weight):
        return out / weight[None]

    return fake_normalize


# ---------------------------------------------------------------------------
# the JAX cases, on both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PACKAGES)
def test_contract_accepts_matching_shapes(pkg):
    f = _fake_normalize(pkg)
    out = f(_arr(pkg, (2, 4, 5, 6)), _arr(pkg, (4, 5, 6)))
    assert tuple(out.shape) == (2, 4, 5, 6)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_contract_rejects_rank_mismatch(pkg):
    c = _mod(pkg, "core.contracts")
    with pytest.raises(c.ContractError, match="rank"):
        _fake_normalize(pkg)(_arr(pkg, (4, 5, 6)), _arr(pkg, (4, 5, 6)))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_contract_rejects_inconsistent_named_dims(pkg):
    c = _mod(pkg, "core.contracts")
    with pytest.raises(c.ContractError, match="'z'"):
        _fake_normalize(pkg)(_arr(pkg, (2, 4, 5, 6)), _arr(pkg, (9, 5, 6)))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_contract_rejects_wrong_dtype(pkg):
    c = _mod(pkg, "core.contracts")
    with pytest.raises(c.ContractError, match="dtype"):
        _fake_normalize(pkg)(_arr(pkg, (2, 4, 5, 6), np.float64),
                             _arr(pkg, (4, 5, 6), np.float64))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_contract_exact_extent_and_result(pkg):
    c = _mod(pkg, "core.contracts")

    @c.contract(starts=c.Spec("n", 3, dtype="int32"),
                _result=(c.Spec("n",), c.Spec("n",)))
    def split(starts):
        return starts[:, 0], starts[:, 1]

    a, _ = split(_arr(pkg, (7, 3), np.int32))
    assert tuple(a.shape) == (7,)
    with pytest.raises(c.ContractError, match="extent 3"):
        split(_arr(pkg, (7, 2), np.int32))

    @c.contract(starts=c.Spec("n", 3, dtype="int32"), _result=c.Spec("n",))
    def bad_result(starts):
        return starts  # wrong rank on purpose

    with pytest.raises(c.ContractError, match="result"):
        bad_result(_arr(pkg, (7, 3), np.int32))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_contract_ellipsis_and_ndim_tuple(pkg):
    c = _mod(pkg, "core.contracts")

    @c.contract(x=c.Spec(..., 3), y=c.Spec(ndim=(3, 4)))
    def f(x, y):
        return x

    f(_arr(pkg, (5, 3)), _arr(pkg, (1, 2, 3)))
    f(_arr(pkg, (2, 9, 3)), _arr(pkg, (1, 2, 3, 4)))
    with pytest.raises(c.ContractError):
        f(_arr(pkg, (5, 4)), _arr(pkg, (1, 2, 3)))
    with pytest.raises(c.ContractError, match="ndim"):
        f(_arr(pkg, (5, 3)), _arr(pkg, (2, 3)))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_contract_checks_every_call_of_two_shapes(pkg):
    """The JAX case checks at trace time under ``jax.jit``; the port has
    no trace, so a decorated function is called on CPU tensors of two
    shapes and checks each call."""
    c = _mod(pkg, "core.contracts")
    calls = []

    @c.contract(x=c.Spec("a", "a", dtype="float32"))
    def square_only(x):
        calls.append(1)
        return x * 2

    if pkg == "jax":
        import jax
        import jax.numpy as jnp

        jitted = jax.jit(square_only)
        jitted(jnp.ones((3, 3), jnp.float32))
        with pytest.raises(c.ContractError, match="'a'"):
            jitted(jnp.ones((3, 4), jnp.float32))
        return
    square_only(torch.ones((3, 3)))
    with pytest.raises(c.ContractError, match="'a'"):
        square_only(torch.ones((3, 4)))  # non-square: refused
    assert len(calls) == 1  # the refused call never ran


@pytest.mark.parametrize("pkg", PACKAGES)
def test_check_abstract_validates_without_execution(pkg):
    c = _mod(pkg, "core.contracts")
    calls = []

    @c.contract(x=c.Spec("n", 3, dtype="int32"))
    def f(x):
        calls.append(x)
        return x.sum(axis=1)

    if pkg == "jax":
        import jax
        import jax.numpy as jnp

        good, bad = (jax.ShapeDtypeStruct((5, 3), jnp.int32),
                     jax.ShapeDtypeStruct((5, 2), jnp.int32))
    else:
        good = torch.empty((5, 3), dtype=torch.int32, device="meta")
        bad = torch.empty((5, 2), dtype=torch.int32, device="meta")
    out = c.check_abstract(f, good)
    assert tuple(out.shape) == (5,)
    with pytest.raises(c.ContractError):
        c.check_abstract(f, bad)
    if pkg == "port":
        # it ran on meta tensors: no values, no card
        assert all(t.device.type == "meta" for t in calls)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_contracts_env_kill_switch(pkg, monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_CONTRACTS", "0")
    # violations pass through when disabled
    _fake_normalize(pkg)(_arr(pkg, (4, 5, 6)), _arr(pkg, (4, 5, 6)))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_contract_unknown_param_fails_at_decoration(pkg):
    c = _mod(pkg, "core.contracts")
    with pytest.raises(TypeError, match="no such parameter"):
        @c.contract(nope=c.Spec(ndim=1))
        def f(x):
            return x


@pytest.mark.parametrize("pkg", PACKAGES)
def test_contract_accepts_chunk_objects(pkg):
    c = _mod(pkg, "core.contracts")
    chunk_cls = _mod(pkg, "chunk.base").Chunk

    @c.contract(chunk=c.Spec(ndim=(3, 4)))
    def f(chunk):
        return chunk

    f(chunk_cls(np.zeros((2, 3, 4), np.float32)))
    with pytest.raises(c.ContractError):
        f(np.zeros((2, 2)))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_real_entry_point_contract_fires(pkg):
    """The accumulate kernel declares int32 starts; float starts are the
    classic silent-cast bug this contract exists to catch."""
    c = _mod(pkg, "core.contracts")
    co, Z, Y, X = 1, 2, 8, 16
    pz, py, px = 1, 4, 8
    if pkg == "jax":
        import jax.numpy as jnp

        from chunkflow_tpu.ops.pallas_blend import (
            buffer_padding,
            fused_accumulate_patches,
        )

        pad_y, pad_x = buffer_padding((pz, py, px))
        args = (jnp.zeros((co, Z, Y + pad_y, X + pad_x), jnp.float32),
                jnp.zeros((Z, Y + pad_y, X + pad_x), jnp.float32),
                jnp.ones((1, co, pz, py, px), jnp.float32),
                jnp.ones((1,), jnp.float32), jnp.ones((pz, py, px),
                                                      jnp.float32),
                jnp.zeros((1, 3), jnp.float32))
        kwargs = {"interpret": True}
    else:
        fused_accumulate_patches = accumulate.fused_accumulate_patches
        args = (torch.zeros((co, Z, Y, X)), torch.zeros((Z, Y, X)),
                torch.ones((1, co, pz, py, px)), torch.ones((1,)),
                torch.ones((pz, py, px)), torch.zeros((1, 3)))
        kwargs = {}
    with pytest.raises(c.ContractError, match="int32"):
        fused_accumulate_patches(*args, **kwargs)


# ---------------------------------------------------------------------------
# the port's own: dtype names, check_abstract on meta, the error texts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("make, name", [
    (lambda: torch.zeros(2, dtype=torch.float32), "float32"),
    (lambda: torch.zeros(2, dtype=torch.int32), "int32"),
    (lambda: torch.zeros(2, dtype=torch.uint8), "uint8"),
    (lambda: torch.zeros(2, dtype=torch.bfloat16), "bfloat16"),
    (lambda: np.zeros(2, np.float32), "float32"),
    (lambda: np.zeros(2, np.uint8), "uint8"),
    (lambda: __import__("chunkflow_tpu_torch").Chunk(
        torch.zeros((2, 3, 4), dtype=torch.bfloat16)), "bfloat16"),
    (lambda: __import__("chunkflow_tpu_torch").Chunk(
        np.zeros((2, 3, 4), np.uint16)), "uint16"),
])
def test_spec_names_dtypes_by_their_numpy_name(make, name):
    value = make()
    assert contracts.dtype_name(value.dtype) == name
    Spec(ndim=value.ndim, dtype=name).validate(value, "v", {})
    with pytest.raises(ContractError,
                       match=f"v: dtype {name}, contract wants int64"):
        Spec(dtype="int64").validate(value, "v", {})


def test_check_abstract_runs_port_entry_points_on_meta():
    """``normalize_blend`` and the kernels' wrappers on ``meta`` tensors:
    abstract results, no FLOP, no kernel, the result contract held."""
    from chunkflow_tpu_torch.ops import blend, gather

    out = check_abstract(blend.normalize_blend, torch.empty(3, 8, 16, 16),
                         np.zeros((8, 16, 16), np.float32))
    assert out.device.type == "meta" and tuple(out.shape) == (3, 8, 16, 16)
    with pytest.raises(ContractError, match="'z'"):
        check_abstract(blend.normalize_blend, torch.empty(3, 8, 16, 16),
                       torch.empty(9, 16, 16))
    before = (gather.launches, accumulate.launches)
    patches = check_abstract(
        lambda c, s: gather.gather_patches(c, s, (4, 8, 8)),
        torch.empty((1, 8, 16, 16), dtype=torch.uint8),
        torch.empty((2, 3), dtype=torch.int32))
    assert tuple(patches.shape) == (2, 1, 4, 8, 8)
    assert patches.dtype == torch.float32
    o, w = check_abstract(
        accumulate.fused_accumulate_patches, torch.empty(3, 8, 16, 16),
        torch.empty(8, 16, 16), torch.empty(2, 3, 4, 8, 8),
        torch.empty(2), torch.empty(4, 8, 8),
        torch.empty((2, 3), dtype=torch.int32))
    assert tuple(o.shape) == (3, 8, 16, 16) and o.device.type == "meta"
    with pytest.raises(ContractError, match="int32"):
        check_abstract(
            accumulate.fused_accumulate_patches, torch.empty(3, 8, 16, 16),
            torch.empty(8, 16, 16), torch.empty(2, 3, 4, 8, 8),
            torch.empty(2), torch.empty(4, 8, 8), torch.empty(2, 3))
    assert (gather.launches, accumulate.launches) == before


@pytest.mark.parametrize("read", ["item", "tolist", "nonzero", "numpy"])
def test_check_abstract_names_a_value_read(read):
    """A function that reads tensor values cannot run on meta tensors:
    check_abstract says which function and what failed."""
    def reads_values(x):
        if read == "item":
            return x.sum().item()
        if read == "tolist":
            return x.tolist()
        if read == "nonzero":
            return x.nonzero()
        return x.numpy()

    with pytest.raises(ContractError, match="reads tensor values") as info:
        check_abstract(reads_values, torch.zeros(4))
    assert "reads_values" in str(info.value)


def _violations(c):
    """One call per violation kind, each under the same qualname in both
    packages; returns the error texts."""
    @c.contract(
        a=c.Spec("n", 3, dtype="int32"),
        b=c.Spec("n", ..., dtype=("float32", "bfloat16")),
        d=c.Spec(ndim=2, optional=True),
        _result=(c.Spec("n",), c.Spec("n",)),
    )
    def probe(a, b, d=None, result=None):
        return result

    def ok(shape, dtype):
        return np.zeros(shape, dtype)

    calls = [
        dict(a=None, b=ok((2,), np.float32)),
        dict(a=[1, 2, 3], b=ok((2,), np.float32)),
        dict(a=ok((2,), np.int32), b=ok((2,), np.float32)),
        dict(a=ok((2, 4), np.int32), b=ok((2,), np.float32)),
        dict(a=ok((2, 3), np.int64), b=ok((2,), np.float32)),
        dict(a=ok((2, 3), np.int32), b=ok((5,), np.float32)),
        dict(a=ok((2, 3), np.int32), b=ok((), np.float32)),
        dict(a=ok((2, 3), np.int32), b=ok((2,), np.float64)),
        dict(a=ok((2, 3), np.int32), b=ok((2,), np.float32),
             d=ok((1,), np.int32)),
        dict(a=ok((2, 3), np.int32), b=ok((2,), np.float32),
             result=ok((2,), np.int32)),
        dict(a=ok((2, 3), np.int32), b=ok((2,), np.float32),
             result=(ok((2,), np.int32), ok((3,), np.int32))),
    ]
    texts = []
    for kwargs in calls:
        with pytest.raises(c.ContractError) as info:
            probe(**kwargs)
        texts.append(str(info.value))
    return texts


def test_error_texts_are_the_jax_texts():
    jax_texts = _violations(_mod("jax", "core.contracts"))
    assert _violations(contracts) == jax_texts
    assert len(set(jax_texts)) == len(jax_texts)


def test_accumulate_refuses_float_starts_before_any_work(monkeypatch):
    """A float32 starts table never reaches the plain path or a launch,
    and the buffers keep their bits."""
    plain_calls = []
    real_plain = accumulate.fused_accumulate_patches_plain
    monkeypatch.setattr(accumulate, "fused_accumulate_patches_plain",
                        lambda *a, **k: plain_calls.append(1)
                        or real_plain(*a, **k))
    rng = np.random.default_rng(3)
    out = torch.from_numpy(rng.random((2, 4, 16, 16), dtype=np.float32))
    weight = torch.from_numpy(rng.random((4, 16, 16), dtype=np.float32))
    before = (out.clone(), weight.clone(), accumulate.launches)
    args = (torch.ones((2, 2, 2, 8, 8)), torch.ones(2),
            torch.ones((2, 8, 8)))
    with pytest.raises(ContractError, match="int32"):
        accumulate.fused_accumulate_patches(
            out, weight, *args, torch.zeros((2, 3), dtype=torch.float32))
    assert plain_calls == []
    assert torch.equal(out, before[0]) and torch.equal(weight, before[1])
    assert accumulate.launches == before[2]
    # the same call with an int32 table runs the plain path
    accumulate.fused_accumulate_patches(
        out, weight, *args, torch.zeros((2, 3), dtype=torch.int32))
    assert plain_calls == [1]


# ---------------------------------------------------------------------------
# the nine entry points: same contracts, same verdicts on the same inputs
# ---------------------------------------------------------------------------
SITES = ("fused_accumulate_patches", "fold_accumulate", "local_blend",
         "normalize_blend", "pad_to_batch", "run_fold", "infer",
         "bump_map")

INF = dict(input_patch_size=(4, 16, 16), output_patch_overlap=(2, 8, 8),
           num_output_channels=2, framework="identity", batch_size=2,
           crop_output_margin=False)


def _inferencer(pkg, **extra):
    cls = _mod(pkg, "inference.inferencer").Inferencer
    kwargs = dict(INF, **extra)
    if pkg == "port":
        kwargs["device"] = "cpu"
    return cls(**kwargs)


def _site(pkg, site, rng):
    """``(call(good_args), good args, bad args, contract of the site)``
    for one entry point of one package; the arrays are numpy, made from
    ``rng``, and converted per package by ``call``."""
    def t(a):
        if pkg == "jax":
            import jax.numpy as jnp

            return jnp.asarray(a)
        return torch.from_numpy(np.ascontiguousarray(a))

    f32 = np.float32
    if site == "fused_accumulate_patches":
        co, Z, Y, X, pout = 2, 4, 16, 16, (2, 8, 8)
        if pkg == "jax":
            from chunkflow_tpu.ops.pallas_blend import buffer_padding

            pad_y, pad_x = buffer_padding(pout)
        else:
            pad_y = pad_x = 0
        out = np.zeros((co, Z, Y + pad_y, X + pad_x), f32)
        weight = np.zeros((Z, Y + pad_y, X + pad_x), f32)
        preds = rng.random((2, co) + pout, dtype=f32)
        valid = np.ones(2, f32)
        bump = rng.random(pout, dtype=f32)
        starts = np.array([[0, 0, 0], [2, 8, 8]], np.int32)
        fn = _mod(pkg, "ops.pallas_blend" if pkg == "jax"
                  else "ops.accumulate").fused_accumulate_patches
        kw = {"interpret": True} if pkg == "jax" else {}

        def call(args):
            return fn(*[t(a) for a in args], **kw)

        good = (out, weight, preds, valid, bump, starts)
        bad = (out, weight, preds, valid, bump, starts.astype(f32))
        return call, good, bad, fn.__contract__
    if site == "fold_accumulate":
        fn = _mod(pkg, "ops.fold_blend").fold_accumulate
        geo = ((2, 2, 2), (2, 4, 4), (4, 8, 8), (0, 0, 0), (6, 12, 12))

        def call(args):
            return fn(t(args[0]), *geo)

        stack = rng.random((8, 2, 4, 8, 8), dtype=f32)
        return call, (stack,), (stack[:, 0],), fn.__contract__
    if site == "local_blend":
        # the JAX function takes its forward's params too; the port's
        # contract follows the port's parameters
        blend = _mod(pkg, "ops.blend")
        if pkg == "jax":
            import jax.numpy as jnp

            from chunkflow_tpu.inference.bump import bump_map

            fn = blend.build_local_blend(
                lambda params, x: x, 1, 1, (4, 16, 16), (4, 16, 16), 2,
                jnp.asarray(bump_map((4, 16, 16))))
            extra = (None,)
        else:
            from chunkflow_tpu_torch.inference.bump import bump_map

            fn = blend.build_local_blend(
                lambda x: x, 1, 1, (4, 16, 16), (4, 16, 16), 2,
                torch.tensor(bump_map((4, 16, 16))))
            extra = ()

        def call(args):
            return fn(*[t(a) for a in args], *extra)

        chunk = rng.random((1, 8, 32, 32), dtype=f32)
        starts = np.array([[0, 0, 0], [4, 16, 16]], np.int32)
        valid = np.ones(2, f32)
        good = (chunk, starts, starts, valid)
        bad = (chunk, starts, starts, np.ones(3, f32))
        return call, good, bad, fn.__contract__
    if site == "normalize_blend":
        fn = _mod(pkg, "ops.blend").normalize_blend

        def call(args):
            return fn(*[t(a) for a in args])

        out = rng.random((2, 4, 8, 8), dtype=f32)
        weight = rng.random((4, 8, 8), dtype=f32)
        return (call, (out, weight), (out, weight[:3]), fn.__contract__)
    if site == "pad_to_batch":
        patching = _mod(pkg, "inference.patching")
        fn = patching.pad_to_batch
        grid = patching.enumerate_patches((8, 32, 32), (4, 16, 16),
                                          (4, 16, 16), (2, 8, 8))

        def call(args):
            return fn(*args)

        # the contract is on the result: a grid with float starts (a
        # caller's hand-made grid) is refused on the way out
        bad_grid = grid._replace(
            input_starts=grid.input_starts.astype(f32))
        return call, (grid, 2), (bad_grid, 2), fn.__contract__
    if site == "run_fold":
        inf = _inferencer(pkg, blend="fold")

        def call(args):
            return inf._run_fold(t(args[0]))

        arr = rng.random((1, 8, 32, 32), dtype=f32)
        return (call, (arr,), ((arr * 255).astype(np.uint8),),
                type(inf)._run_fold.__contract__)
    if site == "infer":
        inf = _inferencer(pkg)
        chunk_cls = _mod(pkg, "chunk.base").Chunk

        def call(args):
            # a plane is no chunk: it reaches the contract as it is
            arr = args[0]
            return inf(chunk_cls(arr) if arr.ndim in (3, 4) else arr)

        arr = rng.random((8, 32, 32), dtype=f32)
        return (call, (arr,), (arr[0],), type(inf)._infer.__contract__)
    assert site == "bump_map"
    fn = _mod(pkg, "inference.bump").bump_map
    return (lambda args: fn(*args), ((4, 8, 8),), None, fn.__contract__)


@pytest.mark.parametrize("site", SITES)
def test_entry_points_carry_the_jax_contracts(site):
    """The same seeded inputs through both packages' entry point: both
    accept the good call; both refuse the bad one with the same text;
    and the declared specs are the JAX ones."""
    verdicts = {}
    for pkg in PACKAGES:
        c = _mod(pkg, "core.contracts")
        call, good, bad, declared = _site(pkg, site, np.random.default_rng(7))
        call(good)
        text = None
        if bad is not None:
            with pytest.raises(c.ContractError) as info:
                call(bad)
            text = str(info.value)
        specs = ({k: repr(v) for k, v in declared["args"].items()},
                 repr(declared["result"]))
        verdicts[pkg] = (text, specs)
    assert verdicts["port"] == verdicts["jax"]


def test_kill_switch_checks_nothing(monkeypatch):
    """``CHUNKFLOW_CONTRACTS=0``: the accumulate entry point's contract
    is stripped, and only the kernel wrapper's own guard is left."""
    monkeypatch.setenv("CHUNKFLOW_CONTRACTS", "0")
    out, weight = torch.zeros((1, 2, 8, 8)), torch.zeros((2, 8, 8))
    args = (torch.ones((1, 1, 1, 4, 4)), torch.ones(1), torch.ones((1, 4, 4)))
    with pytest.raises(TypeError) as info:
        accumulate.fused_accumulate_patches(out, weight, *args,
                                            torch.zeros((1, 3)))
    assert not isinstance(info.value, ContractError)
    assert "out_starts must be" in str(info.value)
    assert contract(x=Spec(ndim=1))(lambda x: x)(np.zeros((2, 2))).shape \
        == (2, 2)
