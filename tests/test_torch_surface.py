"""Every public name of the JAX package has its counterpart in the port.

The port was first judged complete by its module tree: each file of
contexture_nerf_tpu/ had a file at the same path in
contexture_nerf_tpu_torch/. That check could not see a function missing
from a file that exists (`load_off`, the kaolin-compatible `rasterize`,
`teacher_v_pred` were). This test looks at names.

The JAX package is read with `ast` and nothing of it is imported. Its public
names are each top-level function and class whose name does not start with
an underscore, and each such method of a public class. Each is looked up in
the port's module at the mirrored path (raster/pallas_raster.py is
raster/raster_kernel.py in the port), which is imported: the name counts
where it is defined in the port, or imported there from the port, and a
method where the port's class or a port base class of it defines it
(Zero123PlusPipeline inherits the teacher's methods from
Zero123PlusTeacher). A name that the port keeps elsewhere or under another
name is in COUNTERPARTS, a JAX/TPU idiom that eager PyTorch has no use for
in NO_COUNTERPART with its reason.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "contexture_nerf_tpu"
PORT_PKG = "contexture_nerf_tpu_torch"
RENAMED = {"raster/pallas_raster.py": "raster/raster_kernel.py"}

# JAX "module.py:qualname" -> the port's "module.py:qualname" (or several)
COUNTERPARTS = {
    "diffusion/vae.py:AutoencoderKL": ("diffusion/vae.py:Encoder",
                                       "diffusion/vae.py:Decoder"),
    "diffusion/vae.py:AutoencoderKL.encode_moments":
        "diffusion/vae.py:encode_moments",
    "diffusion/vae.py:AutoencoderKL.decode": "diffusion/vae.py:decode",
    "ops/attention.py:flash_attention_pallas":
        "ops/attention.py:flash_attention",
    "ops/groupnorm.py:group_norm_silu_pallas":
        "ops/groupnorm.py:group_norm_silu_kernel",
    "ops/groupnorm.py:group_norm_silu_reference":
        "ops/groupnorm.py:group_norm_silu_plain",
    "ops/quant.py:int8_dot_general": "ops/quant.py:int8_linear",
    "ops/quant.py:int8_conv_general_dilated": "ops/quant.py:int8_conv2d",
    "raster/pallas_raster.py:rasterize_geometry_pallas":
        "raster/raster_kernel.py:rasterize_geometry_kernel",
    "training/trainer.py:ConTEXTure.define_view_weights":
        "training/trainer.py:define_view_weights",
    "training/trainer.py:ConTEXTure.prepare_sds":
        "training/trainer.py:prepare_sds",
    "training/trainer.py:ConTEXTure.compute_view_consistency":
        "ops/view_consistency.py:compute_view_consistency",
}

NO_COUNTERPART = {
    "core/fastinit.py:maybe_jit_init":
        "jits flax's parameter init on the TPU; torch initialises a "
        "module's parameters in place, eagerly",
    "diffusion/vae.py:AutoencoderKL.setup":
        "flax's submodule constructor; the port's Encoder and Decoder "
        "build theirs in __init__",
    "models/textured_mesh.py:TexturedMeshModel.init_params":
        "flax's init of the texture MLP's parameter tree; the port's "
        "NeRF2D is an nn.Module that initialises itself",
    "ops/attention.py:record_attention_calls":
        "a trace hook read only by the TPU's MFU tool "
        "(tools/mfu_attribution.py)",
}


def jax_modules():
    return sorted(str(p.relative_to(JAX_PKG))
                  for p in JAX_PKG.rglob("*.py"))


def public_names(rel: str):
    """The public top-level functions and classes of a JAX module, and the
    public methods of its public classes, as qualnames."""
    tree = ast.parse((JAX_PKG / rel).read_text(), filename=rel)
    names = []
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if not isinstance(node, defs + (ast.ClassDef,)) or \
                node.name.startswith("_"):
            continue
        names.append(node.name)
        if isinstance(node, ast.ClassDef):
            names += [f"{node.name}.{m.name}" for m in node.body
                      if isinstance(m, defs) and not m.name.startswith("_")]
    return names


def port_module(rel: str):
    """The port's module at `rel`, or None where the port has no such
    file (core/fastinit.py, whose one name is a JAX idiom)."""
    dotted = rel[:-len(".py")].replace("/", ".")
    if dotted.endswith("__init__"):
        dotted = dotted[:-len(".__init__")]
    name = f"{PORT_PKG}.{dotted}" if dotted else PORT_PKG
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None


def _from_port(obj) -> bool:
    return getattr(obj, "__module__", "").split(".")[0] == PORT_PKG


def port_has(rel: str, qualname: str) -> bool:
    """Whether the port's module at `rel` has `qualname`: a function or
    class of the port, or a method that a port class in its MRO defines."""
    obj = port_module(rel)
    if obj is None:
        return False
    parts = qualname.split(".")
    for part in parts[:-1]:
        obj = getattr(obj, part, None)
        if not isinstance(obj, type) or not _from_port(obj):
            return False
    name = parts[-1]
    if isinstance(obj, type):
        return any(name in vars(k) for k in obj.__mro__ if _from_port(k))
    return _from_port(getattr(obj, name, None))


@pytest.mark.parametrize("rel", jax_modules())
def test_every_public_name_has_a_counterpart(rel):
    port_rel = RENAMED.get(rel, rel)
    missing = [q for q in public_names(rel)
               if f"{rel}:{q}" not in COUNTERPARTS
               and f"{rel}:{q}" not in NO_COUNTERPART
               and not port_has(port_rel, q)]
    assert not missing, (f"contexture_nerf_tpu/{rel}: {missing} have no "
                         f"counterpart in {PORT_PKG}/{port_rel}")


def test_counterparts_name_existing_names_on_both_sides():
    for key, targets in COUNTERPARTS.items():
        rel, qualname = key.split(":")
        assert qualname in public_names(rel), f"{key} is not in the JAX package"
        for target in (targets,) if isinstance(targets, str) else targets:
            assert port_has(*target.split(":")), f"{key}: no port {target}"


def test_no_counterpart_holds_only_jax_idioms():
    assert len(NO_COUNTERPART) <= 4
    for key, reason in NO_COUNTERPART.items():
        rel, qualname = key.split(":")
        assert qualname in public_names(rel), f"{key} is not in the JAX package"
        assert reason
        # a name that the port has after all leaves the table
        assert not port_has(RENAMED.get(rel, rel), qualname), key


def test_the_check_sees_a_missing_function(monkeypatch):
    """The check fails on a public function that the port lacks."""
    from contexture_nerf_tpu_torch.models import mesh

    assert port_has("models/mesh.py", "load_off")
    assert port_has("models/mesh.py", "Mesh.standardize_mesh")
    monkeypatch.delattr(mesh, "load_off")
    monkeypatch.delattr(mesh.Mesh, "standardize_mesh")
    assert not port_has("models/mesh.py", "load_off")
    assert not port_has("models/mesh.py", "Mesh.standardize_mesh")
    # a name imported from outside the port does not count
    assert not port_has("models/mesh.py", "dataclass")
