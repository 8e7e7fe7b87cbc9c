"""Packaging parity: the reference is
pip-installable (reference setup.py:1-12); this repo ships
pyproject.toml + console-script entry points."""

import pathlib
import tomllib

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_pyproject_declares_package_and_scripts():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert meta["project"]["name"] == "evostencils-tpu"
    scripts = meta["project"]["scripts"]
    assert scripts["evostencils-optimize"] == "evostencils_tpu.cli:optimize_main"
    assert scripts["evostencils-bench"] == "evostencils_tpu.cli:bench_main"


def test_cli_resolves_repo_drivers():
    from evostencils_tpu import cli
    mod = cli._load("optimize.py")
    assert callable(mod.main)
    mod = cli._load("bench.py")
    assert callable(mod.main)
