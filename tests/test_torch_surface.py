"""The port's public surface against the JAX package's, read from the
source with ``ast`` (neither package is imported).

Each check lists what ``serenade_tpu/`` offers and what
``serenade_tpu_torch/`` lacks of it, and fails naming every missing piece:

* ``names``: every public top-level function and class of each module, and
  every public method of its public classes, has a counterpart of the same
  name in the port's module of the same path;
* ``exports``: every name a package ``__init__.py`` re-exports;
* ``flags``: every ``add_argument("--...")`` of ``bin/X.py``;
* ``routes``: the HTTP routes of the servers;
* ``registry``: every ``(kind, name)`` the JAX package registers with
  ``@register`` resolves in the port;
* ``allow_table``: every entry below carries its reason and still names a
  piece of the JAX package that has no counterpart of the same name.

The allow-table holds the pieces whose counterpart has another name or
form; each entry says which and why.
"""

from __future__ import annotations

import ast
import functools
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "serenade_tpu", REPO / "serenade_tpu_torch"

# JAX module -> its counterpart in the port, where the file has none
MODULES = {
    "ops/flash_pallas.py":
        "the Pallas flash attention (K1 forward, K4 dQ, K5 dK/dV) became "
        "csrc/flash_fwd.cu and csrc/flash_bwd.cu, written for Hopper, "
        "behind ops/flash_cuda.py",
    "ops/block1d_pallas.py":
        "the fused Block1D (K2 forward, K6 dx, K7 dW) became "
        "csrc/block1d_fwd.cu and csrc/block1d_bwd.cu behind "
        "ops/block1d_cuda.py",
    "ops/resblock_pallas.py":
        "the HiFiGAN residual branch (K3) became csrc/resblock_branch.cu "
        "behind ops/resblock_cuda.py",
    "ops/flash.py":
        "the attention dispatcher's plain path is "
        "ops/flash_cuda.py::flash_attention_plain",
    "native/__init__.py":
        "the C++ host analysis bindings are native.py (a module, not a "
        "package: it builds native/serenade_native.cpp itself)",
    "sifigan/torch_twin.py":
        "already PyTorch: the upstream layout the tests load SiFiGAN "
        "checkpoints from; the port's generator is sifigan/generator.py",
}

# "module:name" or "module:Class.method" -> its counterpart, and why
NAMES = {
    "checkpoint.py:abstract_like":
        "an orbax template of sharded ShapeDtypeStructs; the port's "
        "checkpoints are torch files that checkpoint.py restores onto any "
        "layout with no template",
    "models/layers.py:QDense":
        "models/layers.py::Dense (int8 through Dense.use_int8_)",
    "models/layers.py:MaskedGroupNorm":
        "models/layers.py::NormParams holds its parameters and "
        "ops/primitives.py::masked_group_norm computes it",
    "models/layers.py:default_conv_backend":
        "chooses XLA's conv lowering (tap-sum matmuls on the TPU); the "
        "port's convs are torch's conv1d",
    "models/unet.py:default_block1d_backend":
        "chooses XLA or the Pallas Block1D; the port routes in "
        "ops/block1d_cuda.py::block1d (K2 on the card)",
    "modules/phoneme_midi/convert.py:convert_transcription_model":
        "maps an upstream torch state dict to flax; the port loads it "
        "with modules/phoneme_midi/convert.py::load_upstream_state_dict",
    "bin/ssc_decode.py:run":
        "the CLI body; the port's is main(argv) around decode_core, which "
        "bin/ssc_decode_new.py calls as well",
    "vocoder/griffin_lim.py:GriffinLimSynth.apply":
        "flax's apply(params, c) of a stateless module; the port's "
        "GriffinLimSynth is an nn.Module called as synth(c)",
    "quantize.py:QTensor.tree_flatten":
        "JAX's pytree protocol; torch needs none",
    "quantize.py:QTensor.tree_unflatten":
        "JAX's pytree protocol; torch needs none",
}

# methods allowed under any class, and why
METHODS = {
    "setup": "flax's setup(); a port module builds its submodules in "
             "__init__",
}

# registry kinds the port holds in another form: kind -> (module, the
# module-level dict or tuple of names), and why
KIND_FORMS = {
    "scheduler": ("schedulers.py", "SCHEDULERS",
                  "a config's scheduler_type picks a schedule from the "
                  "SCHEDULERS dict"),
    "optimizer": ("trainers/train_step.py", "OPTIMIZERS",
                  "a config's optimizer_type is an Optimizer kind"),
}

SERVERS = ("serving.py", "bin/serve.py", "deploy.py")


@functools.lru_cache(maxsize=None)
def _tree(path: Path):
    return ast.parse(path.read_text(), filename=str(path))


def _modules(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py"))


def _public(name: str) -> bool:
    return not name.startswith("_")


def _defined(path: Path):
    """Top-level names of a module (defs, classes, assignments, imports,
    and the names a module-level ``__getattr__`` serves) and each class's
    attributes, with those of its bases in the same module."""
    names, classes, bases = set(), {}, {}
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            if node.name == "__getattr__":
                names |= {c.value for c in ast.walk(node)
                          if isinstance(c, ast.Constant)
                          and isinstance(c.value, str)}
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            attrs = set()
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    attrs.add(item.name)
                elif isinstance(item, ast.Assign):
                    attrs |= {t.id for t in item.targets
                              if isinstance(t, ast.Name)}
                elif isinstance(item, ast.AnnAssign) and isinstance(
                        item.target, ast.Name):
                    attrs.add(item.target.id)
            classes[node.name] = attrs
            bases[node.name] = [b.id for b in node.bases
                                if isinstance(b, ast.Name)]
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)

    def attrs(cls, seen=()):
        out = set(classes.get(cls, ()))
        for base in bases.get(cls, ()):
            if base not in seen:
                out |= attrs(base, seen + (cls,))
        return out

    return names, {c: attrs(c) for c in classes}


def _jax_names():
    """``module:name`` and ``module:Class.method`` of the JAX package's
    public functions, classes and methods."""
    out = []
    for mod in _modules(JAX):
        if mod in MODULES:
            continue
        for node in _tree(JAX / mod).body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)) or not _public(node.name):
                continue
            out.append((mod, node.name, None))
            if isinstance(node, ast.ClassDef):
                out += [(mod, node.name, item.name) for item in node.body
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                        and _public(item.name)]
    return out


def _label(mod, name, method):
    return f"{mod}:{name}" + (f".{method}" if method else "")


def _missing_names():
    missing = []
    for mod, name, method in _jax_names():
        port = PORT / mod
        if not port.exists():
            missing.append(_label(mod, name, method))
            continue
        names, classes = _defined(port)
        if method is None:
            found = name in names
        else:
            found = method in METHODS or method in classes.get(name, ())
        if not found:
            missing.append(_label(mod, name, method))
    return missing


def _exports(path: Path):
    return {a.asname or a.name for node in _tree(path).body
            if isinstance(node, ast.ImportFrom)
            and (node.level or (node.module or "").startswith("serenade_tpu"))
            for a in node.names if _public(a.asname or a.name)}


def _flags(path: Path):
    return {arg.value for node in ast.walk(_tree(path))
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"
            for arg in node.args
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str)
            and arg.value.startswith("--")}


def _routes(root: Path):
    """The paths a handler compares its request's ``.path`` with."""
    out = set()
    for mod in SERVERS:
        for node in ast.walk(_tree(root / mod)):
            if (isinstance(node, ast.Compare)
                    and isinstance(node.left, ast.Attribute)
                    and node.left.attr == "path"):
                out |= {c.value for c in node.comparators
                        if isinstance(c, ast.Constant)
                        and isinstance(c.value, str)}
    return out


def _registered(root: Path):
    """``(kind, name)`` of every ``@register(kind[, name])`` under root."""
    out = set()
    for mod in _modules(root):
        for node in ast.walk(_tree(root / mod)):
            if not isinstance(node, (ast.ClassDef, ast.FunctionDef)):
                continue
            for dec in node.decorator_list:
                if (isinstance(dec, ast.Call)
                        and getattr(dec.func, "id", None) == "register"):
                    args = [a.value for a in dec.args]
                    out.add((args[0], args[1] if len(args) > 1
                             else node.name))
    return out


def _module_value(path: Path, name: str) -> ast.expr:
    for node in _tree(path).body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            return node.value
    raise KeyError(f"{path.relative_to(REPO)} defines no {name}")


def _literal_names(path: Path, name: str):
    """The keys of a module-level dict, or the items of a tuple (none if
    the module does not define it)."""
    try:
        value = _module_value(path, name)
    except KeyError:
        return set()
    if isinstance(value, ast.Dict):
        return {ast.literal_eval(k) for k in value.keys}
    return set(ast.literal_eval(value))


def check_names():
    return [n for n in _missing_names() if n not in NAMES]


def check_exports():
    missing = []
    for mod in _modules(JAX):
        if not mod.endswith("__init__.py") or mod in MODULES:
            continue
        port = PORT / mod
        have = _defined(port)[0] if port.exists() else set()
        missing += [f"{mod}:{n}" for n in sorted(_exports(JAX / mod) - have)]
    return missing


def check_flags():
    missing = []
    for mod in _modules(JAX / "bin"):
        port = PORT / "bin" / mod
        have = _flags(port) if port.exists() else set()
        missing += [f"bin/{mod} {f}"
                    for f in sorted(_flags(JAX / "bin" / mod) - have)]
    return missing


def check_routes():
    return [f"route {r}" for r in sorted(_routes(JAX) - _routes(PORT))]


def check_registry():
    table = {kind: set(names) for kind, names in ast.literal_eval(
        _module_value(PORT / "config.py", "_REGISTRY")).items()}
    for kind, name in _registered(PORT):
        table.setdefault(kind, set()).add(name)
    for kind, (mod, literal, _) in KIND_FORMS.items():
        table[kind] = _literal_names(PORT / mod, literal)
    return [f"registry {kind}:{name}"
            for kind, name in sorted(_registered(JAX))
            if name not in table.get(kind, ())]


def check_allow_table():
    """Entries without a reason, or naming nothing that still lacks a
    counterpart (a piece ported since, or renamed in the JAX package)."""
    jax_mods = set(_modules(JAX))
    stale = [f"module {m}" for m, why in MODULES.items()
             if not why or m not in jax_mods or (PORT / m).exists()]
    lacking = set(_missing_names())
    stale += [f"name {n}" for n, why in NAMES.items()
              if not why or n not in lacking]
    stale += [f"method {m}" for m, why in METHODS.items() if not why]
    kinds = {kind for kind, _ in _registered(JAX)}
    stale += [f"kind {k}" for k, form in KIND_FORMS.items()
              if not form[2] or k not in kinds]
    return stale


CHECKS = {"names": check_names, "exports": check_exports,
          "flags": check_flags, "routes": check_routes,
          "registry": check_registry, "allow_table": check_allow_table}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_port_surface_matches_jax_package(check):
    missing = CHECKS[check]()
    assert not missing, (f"{check}: {len(missing)} missing in "
                         f"serenade_tpu_torch/ (or stale in the "
                         f"allow-table): " + ", ".join(missing))
