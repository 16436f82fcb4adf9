"""``sherf_tpu_torch`` and ``chip_smoke.py`` import nothing of JAX, flax,
optax, orbax or the JAX package ``sherf_tpu``, nor an imaging package
(cv2, imageio, PIL): the machine with the GPU has none of them."""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "sherf_tpu", "cv2",
          "imageio", "PIL")
# modules of every sub-package, which the walk below must reach
EXPECTED = ("sherf_tpu_torch.cli.eval", "sherf_tpu_torch.cli.train",
            "sherf_tpu_torch.data.sampler", "sherf_tpu_torch.eval.test_loop",
            "sherf_tpu_torch.eval.png", "sherf_tpu_torch.geometry.cameras",
            "sherf_tpu_torch.train.loop", "sherf_tpu_torch.kernels.knn",
            "sherf_tpu_torch.cli.calc_metrics", "sherf_tpu_torch.train.gan",
            "sherf_tpu_torch.features.discriminator",
            "sherf_tpu_torch.features.inception",
            "sherf_tpu_torch.eval.gan_metrics",
            "sherf_tpu_torch.compat.legacy_import",
            "sherf_tpu_torch.geometry.shape", "sherf_tpu_torch.eval.gif",
            "sherf_tpu_torch.cli.gen_videos", "sherf_tpu_torch.cli.gen_samples",
            "sherf_tpu_torch.cli.render_demo",
            "sherf_tpu_torch.cli.debug_project",
            "sherf_tpu_torch.cli.visualizer", "sherf_tpu_torch.viz.renderer",
            "sherf_tpu_torch.viz.widgets", "sherf_tpu_torch.viz.server",
            "sherf_tpu_torch.parallel.mesh",
            "sherf_tpu_torch.parallel.multihost",
            "sherf_tpu_torch.parallel.render",
            "sherf_tpu_torch.parallel.launch",
            "sherf_tpu_torch.parallel.reference",
            "sherf_tpu_torch.native", "sherf_tpu_torch.data.bmp",
            "sherf_tpu_torch.data.image_folder",
            "sherf_tpu_torch.cli.dataset_tool",
            "sherf_tpu_torch.features.stylegan3",
            "sherf_tpu_torch.features.augment")

CHILD = textwrap.dedent(f"""
    import importlib, pkgutil, sys
    BANNED = {BANNED!r}
    banned = lambda name: name.split(".")[0] in BANNED

    class Block:
        def find_spec(self, name, path=None, target=None):
            if banned(name):
                raise ImportError("blocked import of " + name)
            return None

    before = {{m for m in sys.modules if banned(m)}}
    sys.meta_path.insert(0, Block())
    import sherf_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(sherf_tpu_torch.__path__,
                                                   "sherf_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    after = {{m for m in sys.modules if banned(m)}}
    assert after == before, sorted(after - before)
    missing = set({EXPECTED!r}) - set(names)
    assert not missing, sorted(missing)
    print("imported", len(names))
""")


def test_import_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert int(p.stdout.split()[-1]) >= 40


def _sources():
    root = os.path.join(REPO, "sherf_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_banned_import_statement_anywhere():
    """Also catches imports inside functions, which importing never runs."""
    bad = []
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names
                    if n.split(".")[0] in BANNED]
    assert not bad, bad
