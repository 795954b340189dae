"""What a run loads: never `jax`, `jaxlib`, `flax` or the JAX package
`yalm_tpu`, compared by whole top-level name (the port's own name,
`yalm_tpu_torch`, begins with `yalm_tpu`); and the reference loads nothing
of the port."""

import subprocess
import sys

from h100bench import harness

ROOT = str(harness.ROOT)


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    mods = _modules("import h100bench.harness, h100bench.serve, h100bench.spans\n"
                    "import yalm_tpu_torch.server, yalm_tpu_torch.scheduler\n"
                    "import yalm_tpu_torch.models.fast")
    assert "yalm_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules("import h100bench.reference.judge, h100bench.reference.model")
    assert not mods & {"yalm_tpu_torch", *harness.FORBIDDEN}


def test_names_are_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["yalm_tpu_torch_fake.x"] = sys
        assert "yalm_tpu" not in harness.forbidden_modules()
        sys.modules["yalm_tpu.models"] = sys
        assert "yalm_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
