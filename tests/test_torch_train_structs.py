"""The port's shape structs against ``repro.launch.steps``'s.

For every registry arch at its full config and every ``INPUT_SHAPES``
entry through ``variant_for_shape``, ``input_specs``,
``cache_specs_struct`` (decode shapes), ``params_struct`` and
``opt_state_struct`` (with ``make_optimizer``'s choice) must give the
reference's trees, leaf by leaf, in shape and dtype. The reference's
structs are ``jax.ShapeDtypeStruct``s on ``make_debug_mesh()``; the
port's are ``device="meta"`` tensors, which allocate nothing (the
optimizers' step counter is a host int where the reference holds an
int32 scalar). Shapes and dtypes are exact.

``variant_for_shape`` changes only the attention window, on which no
parameter shape depends, so the reference's param and optimizer structs
are traced once per arch: its ``eval_shape`` of ``init`` takes ~33 s for
qwen3-moe's 94 x 128 experts, so ``params_struct`` is memoised (in
memory, on ``repro.launch.steps``) for ``opt_state_struct``'s second
call. The port's structs are built for every variant.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.launch import steps as JS
from repro.launch.mesh import make_debug_mesh
from repro_torch.configs import registry as treg
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import steps as TS
from repro_torch.utils import tree_leaves


def _same(want, got):
    """Same tree (keys, lists, leaf count) and, leaf by leaf, the same
    shape and dtype."""
    assert jax.tree.structure(want) == jax.tree.structure(got)
    jl, tl = jax.tree.leaves(want), tree_leaves(got)
    for a, b in zip(jl, tl):
        if isinstance(b, int):              # an optimizer's step counter
            assert a.shape == () and np.dtype(a.dtype) == np.int32
            continue
        assert b.device.type == "meta"
        assert (a.shape, np.dtype(a.dtype).name) == (
            tuple(b.shape), str(b.dtype).removeprefix("torch.")), (a, b)


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_structs_match_reference(arch, monkeypatch):
    mesh = make_debug_mesh()
    monkeypatch.setattr(JS, "params_struct",
                        functools.lru_cache(maxsize=1)(JS.params_struct))
    for name, shape in INPUT_SHAPES.items():
        jshape = J_SHAPES[name]
        jcfg = jreg.variant_for_shape(jreg.get_config(arch), jshape)
        cfg = treg.variant_for_shape(treg.get_config(arch), shape)
        _same(JS.input_specs(jcfg, jshape, mesh), TS.input_specs(cfg, shape))
        if shape.kind == "decode":
            _same(JS.cache_specs_struct(jcfg, jshape, mesh),
                  TS.cache_specs_struct(cfg, shape))
        base = dataclasses.replace(jcfg, sliding_window=0)
        _same(JS.params_struct(base, mesh), TS.params_struct(cfg))
        _same(JS.opt_state_struct(base, mesh, JS.make_optimizer(base)),
              TS.opt_state_struct(cfg, TS.make_optimizer(cfg)))
