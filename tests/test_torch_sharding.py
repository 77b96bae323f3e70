"""repro_torch.launch.sharding against the reference's rules.

For every architecture, at its smoke and its full configuration (on the
meta device: nothing is allocated), every parameter's placements equal
the reference's spec on ``AbstractMesh((16, 16))`` and
``AbstractMesh((2, 16, 16))``, under the four profiles and with sequence
parallelism, for the parameters (``param_sharding_tree``, FSDP included)
and for the optimizer state (``opt_state_spec``).

The reference stacks a pattern position's layers over a leading repeat
axis; the port keeps one tensor per layer. Port names map to the
reference's paths by inverting ``models.convert.flat_from_jax``: a tree of
the reference's shapes whose every leaf is a broadcast view of its own
index goes through it, and each port tensor reads its leaf's index. A
stacked leaf's spec loses its repeat axis. Where the reference puts a
mesh axis on the repeat axis itself, the port takes the spec the
reference gives the same tensor unstacked (a tail layer's); those names
are listed per architecture in ``REPEAT_AXIS``.

The reference keeps its rules in module globals; every call here runs
with them set from a snapshot and restored after, so no other test in the
process sees a changed profile.
"""

import contextlib
import dataclasses
import math

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as ref_base
from repro.launch import sharding as ref_sh
from repro.models import model as ref_model
from repro_torch.configs import base
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.convert import flat_from_jax
from repro_torch.models.model import Model

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = [("tp", False), ("dp", False), ("dp16", False), ("fsdp", False), ("tp", True)]

# (arch, smoke): the port names whose reference optimizer-state spec puts a
# mesh axis on the repeat axis, under some profile and mesh. None at the
# registered configurations: the stacked (n_rep,) cross-block gates take
# "data" there only when n_rep is a multiple of 16, and llama-vision has 8
# repeats (1 at smoke). test_repeat_axis_specs_take_the_tail_spec builds
# such a model.
REPEAT_AXIS = {}


@contextlib.contextmanager
def reference_rules(profile, sequence_parallel):
    saved = dict(ref_sh.LOGICAL_RULES), ref_sh.FSDP, ref_sh.GATHERED_EMBED
    try:
        ref_sh.apply_profile(profile)
        ref_sh.set_sequence_parallel(sequence_parallel)
        yield
    finally:
        ref_sh.LOGICAL_RULES.clear()
        ref_sh.LOGICAL_RULES.update(saved[0])
        ref_sh.FSDP, ref_sh.GATHERED_EMBED = saved[1], saved[2]


def _placements(spec, names, drop_first):
    """A reference PartitionSpec as one placement per mesh dim; with
    ``drop_first`` its first (repeat) dim removed. None if a mesh axis
    sits on the dropped dim."""
    entries = list(spec)
    if drop_first:
        if entries and entries[0] is not None:
            return None
        entries = entries[1:]
    out = [Replicate()] * len(names)
    for d, entry in enumerate(entries):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        assert [names.index(a) for a in axes] == sorted(names.index(a) for a in axes)
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _model(arch, smoke, **overrides):
    """(cfg, {port name: shape}, {port name: (ref path, ref shape)})."""
    cfg = dataclasses.replace(base.get_config(arch, smoke=smoke), **overrides)
    ref_cfg = dataclasses.replace(ref_base.get_config(arch, smoke=smoke), **overrides)
    tree = jax.eval_shape(lambda: ref_model.init_params(jax.random.PRNGKey(0), ref_cfg))
    paths, _ = ref_sh._flatten_with_paths(tree)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    ids = jax.tree_util.tree_unflatten(treedef, [
        np.broadcast_to(np.int64(i), leaf.shape) for i, leaf in enumerate(leaves)])
    flat = flat_from_jax(ids, cfg)
    named = {n: tuple(p.shape) for n, p in Model(cfg, "meta").named_parameters()}
    where = {n: paths[int(a[(0,) * a.ndim])] for n, a in flat.items()}
    return cfg, named, {n: (p, tuple(leaf.shape)) for n, (p, leaf) in where.items()}


@pytest.fixture(scope="module")
def models():
    """{(arch, smoke): _model(arch, smoke)} for every architecture."""
    return {(arch, smoke): _model(arch, smoke)
            for arch in base.list_archs() for smoke in (True, False)}


def _compare(models, key, mesh_name, profile, sp):
    cfg, named, where = models[key]
    sizes, names = MESHES[mesh_name]
    ref_mesh = AbstractMesh(sizes, names)
    mesh = MeshShape(sizes, names)
    rules = sh.rules_for(profile, sequence_parallel=sp)
    port_params = sh.param_placements(named, mesh, rules, cfg)
    port_opt = sh.opt_state_placements(named, mesh, rules)
    exceptions = set()
    with reference_rules(profile, sp):
        for name, shape in named.items():
            path, ref_shape = where[name]
            stacked = len(ref_shape) == len(shape) + 1
            assert ref_shape[stacked:] == shape, name
            spec = ref_sh._sanitize(ref_sh.param_spec(path, len(ref_shape)), ref_shape, ref_mesh)
            if ref_sh.FSDP and math.prod(ref_shape) > 1 << 16:
                spec = ref_sh._fsdp_spec(spec, ref_shape, ref_mesh)
            want = _placements(spec, names, stacked)
            assert want is not None, (name, spec)
            assert port_params[name] == want, (name, path, spec, port_params[name])

            ospec = ref_sh.opt_state_spec(path, len(ref_shape), ref_shape, ref_mesh)
            want = _placements(ospec, names, stacked)
            if want is None:                        # an axis on the repeat axis
                exceptions.add(name)
                want = _placements(ref_sh.opt_state_spec(path, len(shape), shape, ref_mesh),
                                   names, False)
            assert port_opt[name] == want, (name, path, ospec, port_opt[name])
    return exceptions


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", base.list_archs())
def test_placements_equal_the_reference(models, arch, mesh_name):
    for smoke in (True, False):
        seen = set()
        for profile, sp in VARIANTS:
            seen |= _compare(models, (arch, smoke), mesh_name, profile, sp)
        assert sorted(seen) == sorted(REPEAT_AXIS.get((arch, smoke), ())), (arch, smoke, seen)


def test_repeat_axis_specs_take_the_tail_spec():
    """llama-vision smoke at 80 layers: 16 repeats of (attn ×4, cross), so
    the reference's stacked (16,) gates take P("data") on the repeat axis
    for their optimizer state; the port's () gates replicate, as the
    reference's unstacked gates do."""
    key = ("llama-3.2-vision-11b", True)
    cfg, named, where = _model(*key, num_layers=80)
    gates = sorted(n for n in named if n.endswith(("gate_attn", "gate_mlp")))
    assert len(gates) == 32
    seen = set()
    for profile, sp in VARIANTS:
        seen |= _compare({key: (cfg, named, where)}, key, "16x16", profile, sp)
    assert sorted(seen) == gates


def test_reference_globals_are_left_as_they_were():
    before = dict(ref_sh.LOGICAL_RULES), ref_sh.FSDP, ref_sh.GATHERED_EMBED
    with reference_rules("fsdp", True):
        assert ref_sh.FSDP and ref_sh.LOGICAL_RULES["seq"] == "model"
    assert (dict(ref_sh.LOGICAL_RULES), ref_sh.FSDP, ref_sh.GATHERED_EMBED) == before


@pytest.mark.parametrize("profile", ["tp", "dp", "dp16", "fsdp"])
def test_rules_equal_the_reference_globals(profile):
    for sp in (False, True):
        with reference_rules(profile, sp):
            want = dict(ref_sh.LOGICAL_RULES), ref_sh.FSDP
        rules = sh.rules_for(profile, sequence_parallel=sp)
        assert (dict(rules.logical), rules.fsdp) == want
    assert sh.DEFAULT_RULES == sh.rules_for("tp")
    with pytest.raises(ValueError, match="unknown sharding profile"):
        sh.rules_for("zero3")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_data_spec_and_resolve_equal_the_reference(mesh_name):
    sizes, names = MESHES[mesh_name]
    ref_mesh = AbstractMesh(sizes, names)
    cases = [("batch", "seq", "embed"), ("batch_unembed", "seq", "vocab"),
             ("batch", "heads", "seq", None), ("batch_dp", "experts", None, "embed"),
             ("batch", "seq", "ffn"), (None, "vocab")]
    for profile, sp in VARIANTS:
        rules = sh.rules_for(profile, sequence_parallel=sp)
        for axes in cases:
            with reference_rules(profile, sp):
                want = _placements(ref_sh.data_spec(ref_mesh, *axes).spec, names, False)
            assert sh.data_spec(MeshShape(sizes, names), *axes, rules=rules) == want, axes


def test_constrain_is_a_no_op_without_a_mesh():
    import torch

    x = torch.ones(4, 8)
    assert sh.constrain(x, ("batch", "embed")) is x
    with sh.axis_ctx(MeshShape((16, 16), ("data", "model"))):
        assert sh.constrain(x, ("batch", "embed")) is x         # a plain tensor
