"""The port's SPMD lint (DV701–DV705), against the JAX pass.

Each fixture of ``tests/test_spmd_lint.py`` runs through the JAX pass as it
is and through the port's pass translated into ``torch.distributed``, line
for line (:func:`translate`); both must give the same rule ids at the same
lines. The translation table:

====================================================  =========================
JAX                                                   torch
====================================================  =========================
``import jax``                                        ``import torch.distributed
                                                      as dist``
``from jax import lax``, ``import jax.numpy as jnp``, ``import torch`` (or the
``from jax.experimental import multihost_utils``      ``dist`` import when no
                                                      ``import jax`` precedes)
``jax.process_index()`` (a rank source)               ``dist.get_rank()``
``jax.process_count()``, ``jax.device_count()``       ``dist.get_world_size()``
(uniform, not a source)
``len(jax.local_devices())`` (a host source)          ``torch.cuda.device_count()``
``lax.psum(x, "data")``                               ``dist.all_reduce(x)``
``multihost_utils.sync_global_devices(name)``         ``dist.barrier()``
``jnp.zeros(n)`` (a traced shape)                     ``torch.zeros(n)``
``masters_thesis_tpu.parallel.mesh.fleet_barrier``    ``masters_thesis_tpu_torch``'s
====================================================  =========================

The rest holds the port's own tree clean and the port's own sources of
rank and collectives.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from masters_thesis_tpu.analysis.spmd import lint_spmd as jax_lint_spmd
from masters_thesis_tpu_torch.analysis.__main__ import SPMD_PATHS
from masters_thesis_tpu_torch.analysis.spmd import lint_spmd

REPO = Path(__file__).resolve().parents[1]
PACKAGE_ROOT = REPO / "masters_thesis_tpu_torch"

#: (JAX spelling, torch spelling), applied in order.
TRANSLATION = [
    (r"from masters_thesis_tpu\.parallel", "from masters_thesis_tpu_torch.parallel"),
    (r"len\(jax\.local_devices\(\)\)", "torch.cuda.device_count()"),
    (r"jax\.process_index\(\)", "dist.get_rank()"),
    (r"jax\.process_count\(\)", "dist.get_world_size()"),
    (r"jax\.device_count\(\)", "dist.get_world_size()"),
    (r"lax\.psum\((.*), \"data\"\)", r"dist.all_reduce(\1)"),
    (r"multihost_utils\.sync_global_devices\(name\)", "dist.barrier()"),
    (r"jnp\.zeros\(", "torch.zeros("),
]
JAX_IMPORTS = ("from jax import lax", "import jax.numpy as jnp",
               "from jax.experimental import multihost_utils")


def translate(source: str) -> str:
    """A JAX fixture in ``torch.distributed``, line for line."""
    lines = []
    have_dist = False
    for line in source.splitlines():
        if line == "import jax" or (line in JAX_IMPORTS and not have_dist):
            line, have_dist = "import torch.distributed as dist", True
        elif line in JAX_IMPORTS:
            line = "import torch"
        for pattern, repl in TRANSLATION:
            line = re.sub(pattern, repl, line)
        lines.append(line)
    return "\n".join(lines) + "\n"


#: (name, JAX source): the fixtures of tests/test_spmd_lint.py.
FIXTURES = [
    ("dv701_rank_branch_guards_barrier", """
import jax
from masters_thesis_tpu.parallel.mesh import fleet_barrier


def publish(tag):
    if jax.process_index() == 0:
        fleet_barrier(f"publish.{tag}")
"""),
    ("dv701_env_early_exit_skips_schedule", """
import os
from masters_thesis_tpu.parallel.mesh import fleet_barrier


def run():
    if os.environ.get("MTT_SKIP"):
        return
    fleet_barrier("epoch")
"""),
    ("dv701_tainted_loop_bound", """
import jax
from jax import lax


def reduce_all(shards):
    for shard in range(len(jax.local_devices())):
        lax.psum(shard, "data")
"""),
    ("dv701_clean_uniform_guard", """
import jax
from jax.experimental import multihost_utils


def fleet_barrier(name):
    if jax.process_count() <= 1:
        return
    multihost_utils.sync_global_devices(name)
"""),
    ("dv701_clean_barrier_outside_gate", """
import jax
from masters_thesis_tpu.parallel.mesh import fleet_barrier


def publish(tag, payload):
    if jax.process_index() == 0:
        print("publishing", tag)
    fleet_barrier(f"publish.{tag}")
"""),
    ("dv701_suppressed_with_reason", """
import jax
from masters_thesis_tpu.parallel.mesh import fleet_barrier


def publish(tag):
    if jax.process_index() == 0:  # mtt: disable=DV701 -- single-rank debug tool, never run on a fleet
        fleet_barrier(f"publish.{tag}")
"""),
    ("dv702_branches_issue_different_schedules", """
import jax
from jax import lax
from masters_thesis_tpu.parallel.mesh import fleet_barrier


def step(x, rank):
    if rank == 0:
        fleet_barrier("sync")
        lax.psum(x, "data")
    else:
        lax.psum(x, "data")
        fleet_barrier("sync")
"""),
    ("dv702_clean_same_schedule_both_branches", """
from jax import lax


def step(x, rank):
    if rank == 0:
        print("lead")
        lax.psum(x, "data")
    else:
        lax.psum(x, "data")
"""),
    ("dv703_rank_flows_into_collective_operand", """
import jax
from jax import lax


def bad(x):
    offset = jax.process_index() * 10
    return lax.psum(x + offset, "data")
"""),
    ("dv703_host_len_flows_into_traced_shape", """
import jax
import jax.numpy as jnp


def bad():
    n_local = len(jax.local_devices())
    return jnp.zeros(n_local)
"""),
    ("dv703_clean_uniform_shape", """
import jax
import jax.numpy as jnp


def ok(batch_size):
    n = jax.device_count()
    return jnp.zeros(batch_size // n)
"""),
    ("dv704_wall_clock_on_publish_path", """
import json
import time


def save_checkpoint(path, payload):
    payload["ts"] = time.time()
    path.write_text(json.dumps(payload))
"""),
    ("dv704_unseeded_rng_on_resume_path", """
import random


def restore_checkpoint(candidates):
    return random.choice(candidates)
"""),
    ("dv704_unsorted_dir_iteration_transitively_reachable", """
def _scan(ckpt_dir):
    out = []
    for p in ckpt_dir.iterdir():
        out.append(p)
    return out


def restore_checkpoint(ckpt_dir):
    return _scan(ckpt_dir)[-1]
"""),
    ("dv704_clean_seeded_and_sorted", """
import random


def save_checkpoint(ckpt_dir, seed):
    rng = random.Random(seed)
    order = sorted(ckpt_dir.iterdir())
    for p in order:
        pass
    return rng.random()


def unrelated_tool(d):
    for p in d.iterdir():
        pass
"""),
    ("dv705_unfenced_rank0_side_effect", """
import jax


def promote(staging, final):
    if jax.process_index() == 0:
        staging.replace(final)
"""),
    ("dv705_transitive_side_effect_through_helper", """
import jax
import shutil


def _promote(staging, final):
    shutil.move(staging, final)


def publish(staging, final):
    if jax.process_index() == 0:
        _promote(staging, final)
"""),
    ("dv705_clean_when_fenced", """
import jax
from masters_thesis_tpu.parallel.mesh import fleet_barrier


def promote(staging, final, tag):
    if jax.process_index() == 0:
        staging.replace(final)
    fleet_barrier(f"publish.{tag}")
"""),
    ("dv705_regression_unfenced_recovery_shape", """
import jax


def _recover_staged(ckpt_dir, tag):
    (ckpt_dir / f"{tag}.new").replace(ckpt_dir / tag)


def _run_recovery(ckpt_dir, tag):
    if jax.process_index() == 0:
        _recover_staged(ckpt_dir, tag)
"""),
    ("return_taint_crosses_functions", """
import os
from masters_thesis_tpu.parallel.mesh import fleet_barrier


def identity():
    proc = int(os.environ.get("JAX_PROCESS_INDEX", "0"))
    nproc = int(os.environ.get("JAX_PROCESS_COUNT", "1"))
    return proc, nproc


def run(tag):
    proc, nproc = identity()
    if proc == 0:
        fleet_barrier(f"lead.{tag}")
"""),
    ("rank_param_name_is_a_source", """
from masters_thesis_tpu.parallel.mesh import fleet_barrier


def run(rank):
    if rank == 0:
        fleet_barrier("lead")
"""),
]


def _run(lint, tmp_path: Path, name: str, source: str, **kwargs) -> list:
    root = tmp_path / name
    root.mkdir()
    (root / "fix.py").write_text(textwrap.dedent(source))
    return lint([root], **kwargs)


def _rule_lines(findings) -> list[tuple[str, int]]:
    return sorted({(f.rule, f.line) for f in findings})


@pytest.mark.parametrize("name,source", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_gives_the_jax_rules_at_the_jax_lines(tmp_path, name,
                                                     source):
    torch_source = translate(source)
    assert "jax" not in torch_source.replace("JAX_", "")
    want = _rule_lines(_run(jax_lint_spmd, tmp_path, "jax", source))
    got = _rule_lines(_run(lint_spmd, tmp_path, "torch", torch_source))
    assert got == want, (name, got, want)


def test_include_suppressed_marks_instead_of_dropping(tmp_path):
    source = translate(dict(FIXTURES)["dv701_suppressed_with_reason"])
    assert _run(lint_spmd, tmp_path, "a", source) == []
    kept = _run(lint_spmd, tmp_path, "b", source, include_suppressed=True)
    assert [(f.rule, f.suppressed) for f in kept] == [("DV701", True)]
    assert "[suppressed]" in kept[0].format()


@pytest.mark.parametrize("guard,rule", [
    ('int(os.environ["RANK"]) == 0', "DV701"),
    ('os.environ.get("LOCAL_RANK") == "0"', "DV701"),
    ("multihost_rank()[0] == 0", "DV701"),
    ("dist.get_world_size() > 1", None),
], ids=["env_rank", "env_local_rank", "multihost_rank", "world_size"])
def test_port_rank_sources(tmp_path, guard, rule):
    source = f"""
        import os
        import torch.distributed as dist
        from masters_thesis_tpu_torch.utils.backend_probe import multihost_rank


        def publish(flat):
            if {guard}:
                dist.all_reduce(flat)
        """
    found = {f.rule for f in _run(lint_spmd, tmp_path, "p", source)}
    assert found == ({rule} if rule else set())


@pytest.mark.parametrize("call", [
    "_dist().all_reduce(flat)", "mesh.all_reduce_mean_(flat)",
    "mesh.agree([True])", 'fleet_barrier("x")',
    'record_collective("barrier", name="x")', "dist.all_gather(out, flat)",
])
def test_port_collectives_under_a_rank_branch_are_dv701(tmp_path, call):
    source = f"""
        import torch.distributed as dist
        from masters_thesis_tpu_torch.parallel.mesh import fleet_barrier
        from masters_thesis_tpu_torch.telemetry.schedule import record_collective


        def _dist():
            return dist


        def step(mesh, flat, out):
            if dist.get_rank() == 0:
                {call}
        """
    assert {f.rule for f in _run(lint_spmd, tmp_path, "p", source)} == {
        "DV701"}


def test_rank_zero_publish_with_a_torch_save_is_dv705(tmp_path):
    source = """
        import torch
        import torch.distributed as dist


        def publish(state, path):
            if dist.get_rank() == 0:
                torch.save(state, path)
        """
    assert {f.rule for f in _run(lint_spmd, tmp_path, "p", source)} == {
        "DV705"}


def test_port_tree_is_spmd_clean():
    findings = lint_spmd([PACKAGE_ROOT / p for p in SPMD_PATHS],
                         package_root=PACKAGE_ROOT)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_save_checkpoint_has_one_barrier_that_every_rank_passes():
    source = (PACKAGE_ROOT / "train" / "checkpoint.py").read_text()
    assert source.count('fleet_barrier(f"checkpoint.publish.{tag}")') == 1


def test_cli_json_carries_suppression_state():
    out = subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch.analysis", "--spmd",
         "--json"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    findings = json.loads(out.stdout)
    assert findings and all(f["suppressed"] for f in findings)
    assert {f["rule"] for f in findings} == {"DV703", "DV704"}
