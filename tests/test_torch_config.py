"""The port's YAML reader, emitter and config composer against PyYAML and
the JAX package's composer, on the repo's own config files and override
lists. Equality is exact, key order and value types included (``repr``).
PyYAML and the JAX package are imported here only, never by the port."""

import importlib
import importlib.util
import re
import shlex
import sys
from pathlib import Path

import pytest
import yaml

from masters_thesis_tpu.config import compose as jax_compose
from masters_thesis_tpu.config import expand_multirun as jax_expand_multirun
from masters_thesis_tpu.config import to_flat_dict as jax_to_flat_dict
from masters_thesis_tpu_torch.cli.train import CONFIG_DIR, compose_config
from masters_thesis_tpu_torch.config import expand_multirun, to_flat_dict, yaml_subset

jax_compose_mod = importlib.import_module("masters_thesis_tpu.config.compose")
port_compose_mod = importlib.import_module("masters_thesis_tpu_torch.config.compose")

REPO = Path(__file__).resolve().parent.parent
CONFIG_FILES = sorted((REPO / "configs").rglob("*.yaml"))


def _load_jax_driver():
    """Import root ``train.py`` by path, which registers the JAX driver's
    resolvers."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("_driver_train", REPO / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_load_jax_driver()


def _sweep_jobs(script: str) -> list[list[str]]:
    """The override lists of every ``python train.py`` line of a sweep
    script, expanded into jobs (shell variables substituted)."""
    text = (REPO / "sweeps" / script).read_text().replace("\\\n", " ")
    variables = dict(re.findall(r'^(\w+)="([^"]*)"$', text, flags=re.M))
    jobs = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words[:2] != ["python", "train.py"]:
            continue
        words = [re.sub(r"\$(\w+)", lambda m: variables[m.group(1)], w)
                 for w in words[2:] if w != "-m"]
        jobs += jax_expand_multirun(words)
    return jobs


OVERRIDES = {
    "default": [],
    **{f"{group}={option}": [f"{group}={option}"]
       for group in ("model", "loss", "trainer", "datamodule", "launcher", "serve")
       for option in sorted(p.stem for p in (REPO / "configs" / group).glob("*.yaml"))},
    "lookback_252": ["datamodule.lookback_window=252"],
    "add_and_delete": ["+trainer.new_key=1e-4", "+extra.nested.list=[16,32]",
                       "~resilience.probe", "~checkpoint"],
    "nested_resolvers": ["model=kfactor", "datamodule.n_factors=3",
                         "datamodule.interaction_only=false"],
    "typed_values": ["model.learning_rate=1e-3", "trainer.max_epochs=100",
                     "trainer.resume=auto", "trainer.enable_progress_bar=false",
                     "trainer.profile_steps=[1, 2]", "datamodule.data_dir=null",
                     "seed=7", "trainer.gradient_clip_val=.5"],
    "top_level_values": ["checkpoint=logs/x/checkpoints/best",
                         "checkpoint_mode=params",
                         "logger.name=FinancialLstm/warmup"],
    **{f"{script}-{i}": job
       for script in ("example.sh", "experiment_synthetic.sh",
                      "experiment_warmup.sh")
       for i, job in enumerate(_sweep_jobs(script))},
}


def test_sweep_scripts_were_read():
    assert sum(k.startswith("example.sh") for k in OVERRIDES) == 6
    assert sum(k.startswith("experiment_synthetic.sh") for k in OVERRIDES) == 18
    assert sum(k.startswith("experiment_warmup.sh") for k in OVERRIDES) == 7
    assert OVERRIDES["experiment_warmup.sh-1"][-3:] == [
        "checkpoint=logs/FinancialLstm/synthetic/combined_large_lr0.0001_slow"
        "/checkpoints/best",
        "checkpoint_mode=params", "logger.name=FinancialLstm/warmup"]


@pytest.mark.parametrize(
    "path", CONFIG_FILES,
    ids=[str(p.relative_to(REPO / "configs")) for p in CONFIG_FILES])
def test_reader_equals_safe_load(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = yaml_subset.load(path)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("overrides", list(OVERRIDES.values()), ids=list(OVERRIDES))
def test_compose_equals_jax_compose(overrides):
    want = jax_compose(CONFIG_DIR, overrides=overrides)
    got = compose_config(overrides)
    assert repr(got) == repr(want)
    assert repr(to_flat_dict(got)) == repr(jax_to_flat_dict(want))
    # The emitter's output reads back to the same tree, through PyYAML and
    # through the port's reader.
    text = yaml_subset.dump(got)
    assert repr(yaml.safe_load(text)) == repr(got) == repr(yaml_subset.loads(text))
    assert yaml.safe_load(yaml_subset.dump(overrides)) == overrides


@pytest.mark.parametrize("overrides,error", [
    (["model.no_such_key=1"], KeyError),
    (["+model"], ValueError),
    (["model=no_such_option"], FileNotFoundError),
])
def test_compose_refuses_as_jax_compose(overrides, error):
    with pytest.raises(error):
        jax_compose(CONFIG_DIR, overrides=overrides)
    with pytest.raises(error):
        compose_config(overrides)


@pytest.mark.parametrize("text", [
    "1e-4", "1", "-3", "0.5", ".5", "inf", "nan", "true", "False", "yes", "off",
    "null", "~", "", "[1, 2, 4]", "[]", "abc", "a:b", "'quoted'", '"dq"',
    "logs/x/best", "32-true", "${model.name}",
])
def test_override_values_parse_as_jax(text):
    got = port_compose_mod._parse_value(text)
    want = jax_compose_mod._parse_value(text)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("text", ["#comment", "{a: 1}", "2024-01-01", "a: b",
                                  "&anchor", "0x1f"])
def test_override_values_outside_the_subset_raise(text):
    """PyYAML reads these as something other than their text (None, a
    mapping, a date, an int); the port refuses them."""
    with pytest.raises(ValueError, match="outside the YAML subset"):
        port_compose_mod._parse_value(text)
    with pytest.raises(ValueError, match="outside the YAML subset"):
        compose_config([f"logger.name={text}"])


@pytest.mark.parametrize("overrides", [
    ["model.learning_rate=1e-3,1e-4,1e-5", "trainer.max_epochs=100,200"],
    ["dims=[16,32]", "a=1,2", "model=small"],
    ["x={a,b}", "~y", "+z=3,4"],
    [],
])
def test_expand_multirun_equals_jax(overrides):
    assert expand_multirun(overrides) == jax_expand_multirun(overrides)


@pytest.mark.parametrize("text,line", [
    ("a: 0755\n", 1),
    ("a: &anchor 1\n", 1),
    ("a: {b: 1}\n", 1),
    ("a: 2024-01-01\n", 1),
    ("a: 1e-4\n", 1),
    ("a:\n  - b: 1\n    c: 2\n", 3),
    ("a: |\n  text\n", 1),
    ("a:\tb\n", 1),
    ("---\na: 1\n", 1),
    ("a: 1\na: 2\n", 2),
    ("a: b: c\n", 1),
    ("a: 1\n  b: 2\n", 2),
    ("a:\n  b\n", 2),
    ("'quoted key': 1\n", 1),
])
def test_reader_refuses_what_is_outside_the_subset(text, line):
    with pytest.raises(yaml_subset.YamlSubsetError, match=f"^t.yaml:{line}: "):
        yaml_subset.loads(text, "t.yaml")

