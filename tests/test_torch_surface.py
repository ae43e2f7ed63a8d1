"""Every module of the reference (`src/repro`) has its counterpart in the port
(`src/repro_torch`): a file at the same path, and each public top-level
function, class and upper-case constant of the reference either under the
same name there or in `COUNTERPARTS`, which names the port's counterpart
("path.py:name", checked to exist) or says why there is none. Both
packages are read with `ast`, so neither `jax` nor `repro` is imported.
"""
import ast
import pathlib
import re

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

COUNTERPARTS = {
    "core/api.py": {
        "view_loss": "a resident state's parameters are views into its buckets "
                     "(`core.api.init_train_state`), so the loss reads them with no "
                     "view to wrap it in",
    },
    "engine/api.py": {
        "StepExecutor": "a `typing.Protocol` only: the port's executors share its "
                        "methods (the module's docstring) with no class to name them",
    },
    "kernels/mamba2_scan.py": {"mamba2_chunked": "kernels/mamba2_scan.py:mamba2_scan"},
    "kernels/rwkv6_scan.py": {"rwkv6_chunked": "kernels/rwkv6_scan.py:rwkv6_scan"},
    "kernels/sam_perturb.py": {"CHUNK": "kernels/sam_perturb.py:sq_norm_tile"},
    "kernels/ref.py": {
        "adamw_epilogue_flat_jnp": "kernels/ref.py:adamw_epilogue_flat_plain",
        "axpy_flat_jnp": "kernels/ref.py:axpy_flat_plain",
        "decode_attention_jnp": "kernels/ref.py:decode_attention_plain",
        "delta_amax_flat_jnp": "kernels/ref.py:delta_amax_flat_plain",
        "delta_encode_i8_flat_jnp": "kernels/ref.py:delta_encode_i8_flat_plain",
        "dot_norms_flat_jnp": "kernels/ref.py:dot_norms_flat_plain",
        "flash_attention_jnp": "kernels/ref.py:flash_attention_plain",
        "mamba2_chunked_jnp": "kernels/ref.py:mamba2_chunked_plain",
        "mamba2_scan_ref": "kernels/ref.py:mamba2_scan_plain",
        "rwkv6_scan_ref": "kernels/ref.py:rwkv6_scan_plain",
        "sam_perturb_flat_jnp": "kernels/ref.py:sam_perturb_flat_plain",
        "sgd_epilogue_flat_jnp": "kernels/ref.py:sgd_epilogue_flat_plain",
        "sq_norm_jnp": "kernels/ref.py:sq_norm_plain",
    },
    "launch/dryrun.py": {
        name: "a TPU's rate, which the port's records do not use: they carry flops, "
              "bytes and collectives, and `chip_smoke.py` holds the H100's rates"
        for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW")
    },
    "launch/sharding.py": {"to_named": "launch/sharding.py:to_placements"},
    "models/layers.py": {
        "attention_init": "models/transformer.py:init_attention",
        "dense_init": "models/transformer.py:dense_init",
        "embedding_init": "models/transformer.py:Embedding",
        "mlp_init": "models/transformer.py:init_mlp",
        "norm_init": "models/layers.py:norm_shapes",
    },
    "models/mla.py": {"mla_init": "models/mla.py:mla_shapes"},
    "models/moe.py": {"moe_init": "models/moe.py:moe_shapes"},
    "models/partitioning.py": {
        "constrain": "models/partitioning.py:Layout",
        "constrain_first_fit": "models/partitioning.py:tp_leaves",
        "constrain_param_tree": "models/partitioning.py:gather_block",
    },
    "models/rwkv.py": {"channelmix_init": "models/rwkv.py:channelmix_shapes",
                       "timemix_init": "models/rwkv.py:timemix_shapes"},
    "models/ssm.py": {"mamba2_init": "models/ssm.py:mamba2_shapes"},
    "models/transformer.py": {
        "attn_block_init": "models/transformer.py:Block",
        "mamba_block_init": "models/transformer.py:MambaBlock",
        "rwkv_block_init": "models/transformer.py:RWKVBlock",
        "shared_block_init": "models/transformer.py:Block",
        "shared_lora_init": "models/transformer.py:lora_shapes",
    },
}
_COUNTERPART = re.compile(r"^[\w/]+\.py:\w+$")


def _defined(path: pathlib.Path) -> set:
    """Every top-level name `path` binds: defs, classes, assignments and
    imports (a name re-exported from another module counts)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _public(path: pathlib.Path) -> set:
    """The public surface of a reference module: its top-level functions and
    classes without a leading underscore, and its upper-case constants."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name) and t.id.isupper()}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name) \
                and node.target.id.isupper():
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_the_reference_has_modules():
    assert len(MODULES) > 50, MODULES


@pytest.mark.parametrize("module", MODULES)
def test_every_reference_module_is_ported(module):
    """The module's file under the port, and every public name of it there
    or in COUNTERPARTS."""
    port = PORT / module
    assert port.is_file(), f"{module} has no counterpart under src/repro_torch"
    missing = _public(REF / module) - _defined(port) - set(COUNTERPARTS.get(module, {}))
    assert not missing, f"{module}: {sorted(missing)} neither in the port nor in COUNTERPARTS"


def test_every_counterpart_entry_is_current():
    """Each entry of COUNTERPARTS names a public name of its reference module
    that the port does not define under the same name, and either the
    port's counterpart, which exists, or a reason."""
    for module, entries in COUNTERPARTS.items():
        public, here = _public(REF / module), _defined(PORT / module)
        for name, what in entries.items():
            assert name in public and name not in here, (module, name)
            if _COUNTERPART.match(what):
                path, target = what.split(":")
                assert target in _defined(PORT / path), (module, name, what)
            else:
                assert len(what.split()) >= 8, (module, name, what)
