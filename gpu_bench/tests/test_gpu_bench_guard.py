"""The no-JAX guard compares top-level module names whole."""

from gpu_bench.harness.device import forbidden_modules


def test_guard_tells_the_port_from_the_jax_package():
    assert forbidden_modules(["real2sim_eval_tpu_torch",
                              "real2sim_eval_tpu_torch.parallel.batched",
                              "numpy", "jaxtyping"]) == []
    assert forbidden_modules(["real2sim_eval_tpu.renderer",
                              "real2sim_eval_tpu_torch"]) == [
        "real2sim_eval_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_reference_imports_neither_the_program_nor_jax():
    import ast
    from pathlib import Path

    ref = Path(__file__).resolve().parents[1] / "reference"
    for f in ref.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            assert not forbidden_modules(names), (f, names)
            assert all(n.split(".")[0] != "real2sim_eval_tpu_torch"
                       for n in names), (f, names)
