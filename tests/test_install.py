"""Installation contract: the package imports without optional packages,
keeps its compile cache where it should, and the GPU smoke run refuses a
machine without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env_extra=None, drop=(), cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_compile_cache_defaults_inside_the_checkout():
    r = _python("import jax, raytracebvh_tpu as r; "
                "print(jax.config.jax_compilation_cache_dir)",
                drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_honours_the_environment(tmp_path):
    r = _python("import jax, raytracebvh_tpu as r; "
                "print(jax.config.jax_compilation_cache_dir)",
                env_extra={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path)


def test_import_without_flax_or_pillow():
    """flax and Pillow are not dependencies: block both and import the
    package and the frame pipeline's modules."""
    r = _python(
        "import sys; sys.modules['flax'] = None; sys.modules['PIL'] = None\n"
        "import raytracebvh_tpu, raytracebvh_tpu.models.inverse\n"
        "import raytracebvh_tpu.parallel.render, raytracebvh_tpu.io.image\n"
        "s = raytracebvh_tpu.Camera.default()\n"
        "assert s.replace(fov=1.0).fov == 1.0\n"
        "print('ok')")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_png_texture_without_pillow_says_why(tmp_path, monkeypatch):
    from raytracebvh_tpu.io.image import load_texture

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs Pillow"):
        load_texture(str(tmp_path / "t.png"))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_a_cpu_only_machine(tmp_path, alone):
    """Non-zero exit and no result line on the CPU, both in the checkout
    and as a lone copy of the script."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
