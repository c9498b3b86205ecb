"""paddle_tpu_torch's ``nn.Layer`` and its containers against
paddle_tpu's, on the CPU: building (``create_parameter`` with a
``ParamAttr`` and the global initializers, ``add_sublayer``,
``add_parameter``, ``register_buffer(persistable=)``, ``create_tensor``),
walking the tree, ``state_dict`` names equal to the JAX ``named_state()``
names of the same tree (and ``state_dict`` / ``named_state`` equal to
JAX's), ``set_state_dict``, ``swap_state``, modes, ``to`` / ``astype``,
forward hooks and their ``HookRemoveHelper``, ``LayerList``,
``LayerDict``, ``ParameterList``, ``ParameterDict``; every ported layer
class is a ``Layer``; and the weight carry-over (``load_numpy_state``) of
a tree holding ``Bilinear``, ``HSigmoidLoss``,
``AdaptiveLogSoftmaxWithLoss`` and ``SpectralNorm``.

Random initial values are the port's generator's (not JAX's bits): held
to their bounds. Tolerance for values carried across: exact; for outputs
computed from them, 1e-5 of the largest reference value (float32 sums in
another order).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import models as pmodels
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import initializer as pinit
from paddle_tpu_torch.vision import models as pvision

JNN = paddle.nn


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data.astype(jnp.float32))
    return t.detach().float().numpy()


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _tree(nn, **cpu):
    """The same tree of layers in either package (``nn`` the package's
    ``nn``; ``cpu`` the port's placement)."""
    class Block(nn.Layer):
        def __init__(self):
            super().__init__(**({"device": "cpu"} if cpu else {}))
            self.proj = nn.Linear(3, 3, **cpu)
            self.scale = self.create_parameter([3], is_bias=True)
            self.register_buffer("steps", _zeros(nn, 2), persistable=True)

        def forward(self, x):
            return self.proj(x) + self.scale

    class Net(nn.Layer):
        def __init__(self):
            super().__init__(**({"device": "cpu"} if cpu else {}))
            self.blocks = nn.LayerList([Block(), Block()])
            self.heads = nn.LayerDict({"a": nn.Linear(3, 2, **cpu),
                                       "b": nn.Linear(3, 1, **cpu)})
            self.extra = nn.ParameterList([self.create_parameter([2, 2])])
            self.named = nn.ParameterDict(
                {"g": self.create_parameter([3], is_bias=True)})
            self.norm = nn.BatchNorm1D(3, **cpu)
            self.add_sublayer("tail", nn.Sequential(nn.ReLU(),
                                                    nn.Linear(3, 3, **cpu)))
            self.add_parameter("w", self.create_parameter([3, 3]))

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return self.tail(self.norm(x)) @ self.w

    return Net()


def _zeros(nn, n):
    if nn is JNN:
        return paddle.zeros([n])
    return torch.zeros(n)


def test_state_dict_names_are_the_jax_named_state_names():
    """The same tree in both packages: ``state_dict()`` names equal JAX's
    ``named_state()`` names (every buffer persistable here) and JAX's
    ``state_dict()``, in the same order; ``named_state`` equals JAX's."""
    jm, pm = _tree(JNN), _tree(pnn, device="cpu")
    want = list(jm.named_state())
    assert list(pm.state_dict()) == want == list(jm.state_dict())
    assert list(pm.named_state()) == want
    assert [n for n, _ in pm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in pm.named_buffers()] == \
        [n for n, _ in jm.named_buffers()]


def test_carried_tree_computes_as_jax():
    jm, pm = _tree(JNN), _tree(pnn, device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    for name, t in jm.named_state().items():
        assert np.array_equal(pm.state_dict()[name].numpy(),
                              np.asarray(t._data))
    x = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    jm.eval()
    pm.eval()
    _close(pm(torch.from_numpy(x)), jm(paddle.to_tensor(x)))


def test_non_persistable_buffers_stay_out_of_the_state_dict():
    for nn, kw in ((JNN, {}), (pnn, {"device": "cpu"})):
        layer = nn.Layer(**kw)
        layer.register_buffer("a", _zeros(nn, 1))
        layer.register_buffer("b", _zeros(nn, 1), persistable=False)
        assert list(layer.state_dict()) == ["a"]
        assert list(layer.named_state()) == ["a", "b"]
    torch_form = pnn.Layer(device="cpu")
    torch_form.register_buffer("c", torch.zeros(1), persistent=False)
    assert list(torch_form.state_dict()) == []


def test_create_parameter_initializers_and_attributes():
    """Defaults: a bias zeros, a weight Xavier-uniform (inside its
    bound); a ``ParamAttr``'s initializer, name and learning rate; the
    global initializer, overridden by the attribute's; dtype."""
    layer = pnn.Layer(device="cpu")
    b = layer.create_parameter([3], is_bias=True)
    assert torch.equal(b, torch.zeros(3)) and isinstance(b, torch.nn.Parameter)
    w = layer.create_parameter([6, 10])
    w = w.detach()
    assert float(w.abs().max()) <= (6.0 / 16) ** 0.5 and float(w.std()) > 0
    p = layer.create_parameter(
        [2, 2], attr=pinit.ParamAttr(name="named_w", learning_rate=0.5,
                                     initializer=pinit.Constant(0.25)))
    assert torch.equal(p, torch.full((2, 2), 0.25))
    assert p.name == "named_w" and p.optimize_attr == {"learning_rate": 0.5}
    try:
        pinit.set_global_initializer(pinit.Constant(2.0), pinit.Constant(3.0))
        assert torch.equal(layer.create_parameter([2]), torch.full((2,), 2.0))
        assert torch.equal(layer.create_parameter([2], is_bias=True),
                           torch.full((2,), 3.0))
        assert torch.equal(layer.create_parameter(
            [2], attr=pinit.ParamAttr(initializer=pinit.Constant(1.0))),
            torch.ones(2))
    finally:
        pinit.set_global_initializer(None)
    assert layer.create_parameter([2], dtype="bfloat16").dtype == \
        torch.bfloat16
    with pytest.raises(ValueError):
        layer.create_parameter([2], attr=False)
    t = layer.create_tensor(dtype="float32", persistable=True)
    assert t.shape == () and t.persistable


def test_create_parameter_draws_from_the_seed():
    layer = pnn.Layer(device="cpu")
    ptt.seed(4)
    a = layer.create_parameter([5, 5])
    ptt.seed(4)
    assert torch.equal(a, layer.create_parameter([5, 5]))


def test_walking_the_tree_matches_jax():
    jm, pm = _tree(JNN), _tree(pnn, device="cpu")
    for inc in (False, True):
        assert [n for n, _ in pm.named_sublayers(include_self=inc)] == \
            [n for n, _ in jm.named_sublayers(include_self=inc)]
        assert len(pm.sublayers(include_self=inc)) == \
            len(jm.sublayers(include_self=inc))
    assert [n for n, _ in pm.named_children()] == \
        [n for n, _ in jm.named_children()]
    assert len(list(pm.children())) == len(list(jm.children()))
    assert len(pm.parameters()) == len(jm.parameters())
    assert len(pm.parameters(include_sublayers=False)) == \
        len(jm.parameters(include_sublayers=False)) == 1
    assert isinstance(pm.parameters(), list) and isinstance(pm.buffers(),
                                                           list)
    assert len(pm.buffers()) == len(jm.buffers())
    jp = [n for n, _ in jm.named_parameters(prefix="m")]
    assert [n for n, _ in pm.named_parameters(prefix="m")] == jp
    for prefix in ("m", "m."):
        assert list(pm.state_dict(structured_name_prefix=prefix)) == \
            list(jm.state_dict(structured_name_prefix=prefix))
    assert list(pm.state_dict(include_sublayers=False)) == \
        list(jm.state_dict(include_sublayers=False))


def test_set_state_dict_copies_in_place():
    pm = _tree(pnn, device="cpu")
    sd = {k: v.clone() + 1 for k, v in pm.state_dict().items()}
    before = pm.w
    sd.pop("w")
    sd["nope"] = torch.zeros(1)
    missing, unexpected = pm.set_state_dict(sd)
    assert missing == ["w"] and unexpected == ["nope"]
    assert pm.w is before
    for k, v in sd.items():
        if k != "nope":
            assert torch.equal(pm.state_dict()[k], v)
    pm.set_dict({"w": np.ones((3, 3), np.float32)})
    assert torch.equal(pm.w, torch.ones(3, 3))
    with pytest.raises(ValueError, match="shape"):
        pm.load_dict({"w": np.ones((2, 3), np.float32)})


def test_swap_state_runs_with_other_values():
    pm = pnn.Linear(2, 2, device="cpu")
    x = torch.ones(1, 2)
    base = pm(x)
    with pm.swap_state({"weight": torch.zeros(2, 2),
                        "bias": torch.full((2,), 3.0)}):
        assert torch.equal(pm(x), torch.full((1, 2), 3.0))
    assert torch.equal(pm(x), base)


def test_modes_apply_and_casts():
    jm, pm = _tree(JNN), _tree(pnn, device="cpu")
    pm.eval()
    assert not any(m.training for m in pm.sublayers(include_self=True))
    pm.train()
    assert all(m.training for m in pm.sublayers(include_self=True))
    seen_p, seen_j = [], []
    pm.apply(lambda m: seen_p.append(type(m).__name__))
    jm.apply(lambda m: seen_j.append(type(m).__name__))
    assert seen_p == seen_j
    out = pm.to(dtype="bfloat16")
    assert out is pm and pm.w.dtype == torch.bfloat16
    assert pm.blocks[0].steps.dtype == torch.bfloat16
    assert pm.norm._mean.dtype == torch.bfloat16
    assert all(m._dtype == torch.bfloat16 for m in pm.sublayers())
    assert pm.float().w.dtype == torch.float32
    assert pm.astype("float16").w.dtype == torch.float16
    assert pm.to(device="cpu") is pm


@pytest.mark.parametrize("call", [
    lambda m: m.to("cpu", dtype=torch.bfloat16),
    lambda m: m.to("cpu", torch.bfloat16),
    lambda m: m.to(torch.bfloat16, non_blocking=True),
    lambda m: m.to(device="cpu", dtype="bfloat16", non_blocking=True),
    lambda m: m.to(torch.zeros((), dtype=torch.bfloat16)),
    lambda m: m.to(dtype=torch.bfloat16, blocking=True),
])
def test_to_takes_positional_and_keyword_forms_together(call):
    """Every form casts the parameters and floating buffers and sets each
    sublayer's ``_dtype``; none drops the dtype or the device."""
    pm = _tree(pnn, device="cpu")
    assert call(pm) is pm and pm.w.dtype == torch.bfloat16
    assert pm.norm._mean.dtype == torch.bfloat16
    assert all(m._dtype == torch.bfloat16 for m in pm.sublayers())
    pm.to("cpu", non_blocking=True)
    assert pm.w.dtype == torch.bfloat16 and pm.w.device.type == "cpu"


def test_forward_hooks_match_jax():
    """A pre-hook's return replaces the inputs, a post-hook's the outputs;
    ``remove()`` on the ``HookRemoveHelper`` takes each out."""
    x = np.arange(4, dtype=np.float32).reshape(1, 4)
    results = []
    for nn, to, kw in ((JNN, paddle.to_tensor, {}),
                       (pnn, torch.from_numpy, {"device": "cpu"})):
        layer = nn.Linear(4, 2, weight_attr=nn.initializer.Constant(0.5),
                          **kw)
        pre = layer.register_forward_pre_hook(lambda m, inp: inp[0] * 2)
        post = layer.register_forward_post_hook(
            lambda m, inp, out: out + 1)
        a = _np(layer(to(x)))
        pre.remove()
        b = _np(layer(to(x)))
        post.remove()
        c = _np(layer(to(x)))
        results.append((a, b, c))
        if nn is pnn:
            assert isinstance(pre, pnn.HookRemoveHelper)
    for got, want in zip(*results[::-1]):
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_containers_match_jax():
    """``LayerList`` (append, insert, extend, slicing, negative index),
    ``LayerDict`` (set, pop, del, keys, update), ``ParameterList`` and
    ``ParameterDict``: the same names as JAX's after the same calls."""
    names = []
    for nn, kw in ((JNN, {}), (pnn, {"device": "cpu"})):
        lst = nn.LayerList([nn.Linear(2, 2, **kw)])
        lst.append(nn.Linear(2, 3, **kw))
        lst.insert(0, nn.ReLU())
        lst.extend([nn.Linear(3, 3, **kw)])
        assert len(lst) == 4 and len(lst[1:]) == 3
        assert isinstance(lst[-1], nn.Linear)
        dct = nn.LayerDict({"x": nn.Linear(2, 2, **kw)})
        dct["y"] = nn.Linear(2, 1, **kw)
        dct.update([("z", nn.ReLU())])
        popped = dct.pop("x")
        assert isinstance(popped, nn.Linear) and "x" not in dct
        del dct["z"]
        assert list(dct.keys()) == ["y"] and len(dct) == 1
        pl = nn.ParameterList()
        layer = nn.Layer(**kw)
        pl.append(layer.create_parameter([2]))
        pl.append(layer.create_parameter([3]))
        assert len(pl) == 2 and tuple(pl[1].shape) == (3,)
        pd = nn.ParameterDict()
        pd["a"] = layer.create_parameter([1])
        pd.update({"b": layer.create_parameter([2])})
        assert "a" in pd and len(pd) == 2 and list(pd.keys()) == ["a", "b"]
        seq = nn.Sequential(("first", nn.Linear(2, 2, **kw)), ("act",
                                                               nn.ReLU()))
        assert len(seq[0:1]) == 1
        holder = nn.Sequential(lst, dct, seq)
        holder.add_sublayer("pl", pl)
        holder.add_sublayer("pd", pd)
        names.append(list(holder.state_dict()))
    assert names[0] == names[1]


def test_every_ported_layer_is_a_layer():
    """Every layer class of ``nn`` and of the models is an ``nn.Layer``;
    ``in_dynamic_mode`` and its switches as JAX's."""
    classes = [v for v in vars(pnn).values() if inspect.isclass(v)
               and issubclass(v, torch.nn.Module)]
    for mod in (pmodels, pvision):
        classes += [v for v in vars(mod).values() if inspect.isclass(v)
                    and issubclass(v, torch.nn.Module)]
    assert len(classes) > 60
    assert all(issubclass(c, pnn.Layer) for c in classes), \
        [c.__name__ for c in classes if not issubclass(c, pnn.Layer)]
    assert isinstance(pvision.resnet18(num_classes=3, device="cpu"),
                      pnn.Layer)
    assert pnn.in_dynamic_mode()
    try:
        pnn.enable_static()
        assert not pnn.in_dynamic_mode()
    finally:
        pnn.disable_static()
    assert pnn.in_dynamic_mode()


def test_carry_over_of_the_new_parameters_and_buffers():
    """A tree of ``Bilinear``, ``HSigmoidLoss``,
    ``AdaptiveLogSoftmaxWithLoss`` and ``SpectralNorm``: the JAX tree's
    ``named_state()`` loads into the port's (every name known, every
    shape and dtype equal), then each computes as JAX's."""
    def build(nn, **kw):
        tree = nn.LayerDict({
            "bil": nn.Bilinear(3, 4, 2, **kw),
            "hs": nn.HSigmoidLoss(4, 6, **kw),
            "ada": nn.AdaptiveLogSoftmaxWithLoss(4, 10, [3, 6], **kw),
        })
        tree.add_sublayer("sn", nn.SpectralNorm([3, 4], **kw))
        return tree
    jt, pt = build(JNN), build(pnn, device="cpu")
    state = {n: np.asarray(t._data) for n, t in jt.named_state().items()}
    assert list(pt.state_dict()) == list(state)
    load_numpy_state(pt, state)
    rng = np.random.default_rng(2)
    x3, x4 = (rng.standard_normal((5, n)).astype(np.float32) for n in (3, 4))
    y = np.array([0, 2, 5, 7, 9])
    j = lambda a: paddle.to_tensor(a)          # noqa: E731
    p = torch.from_numpy
    _close(pt["bil"](p(x3), p(x4)), jt["bil"](j(x3), j(x4)))
    _close(pt["hs"](p(x4), p(y % 6)), jt["hs"](j(x4), j(y % 6)))
    _close(pt["ada"](p(x4), p(y))[1], jt["ada"](j(x4), j(y))[1])
    w = rng.standard_normal((3, 4)).astype(np.float32)
    _close(pt["sn"](p(w)), jt["sn"](j(w)))
