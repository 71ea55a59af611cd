"""The port's graph audit and lint (``repro_torch.analysis``), on the CPU.

* Every serve family's targets run clean under the graph audit, off and
  on the (1, 1) audit mesh; each mesh target's KV placement table is the
  reference's (``repro.analysis.targets._expected_specs``).
* Every rule has a fixture that fires, and the lint's near-misses stay
  clean; an upcast is attributed to the line that issued it.
* The port's tree lints clean, and the dead-module census works on a
  temporary tree.
* Both records pass the unchanged ``scripts/check_bench_schema.py``, and
  a corrupted summary does not.
"""

import importlib.util
import os
from pathlib import Path

import pytest

from repro_torch.analysis import (RULES, audit_target, build_cost_report,
                                  build_report, enumerate_targets, run_lint)
from repro_torch.analysis import fixtures
from repro_torch.analysis.lint import dead_module_census, lint_source

ROOT = Path(__file__).resolve().parents[1]


def _schema():
    spec = importlib.util.spec_from_file_location(
        "check_bench_schema", ROOT / "scripts" / "check_bench_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def targets():
    return enumerate_targets()


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
@pytest.mark.parametrize("mesh", [False, True])
def test_family_targets_audit_clean(targets, family, mesh):
    mine = [t for t in targets if t.family == family
            and (t.mesh is not None) == mesh]
    assert len(mine) >= 7
    found = [v.format() for t in mine for v in audit_target(t)]
    assert found == []
    if mesh and family in ("dense", "hybrid"):
        assert all(t.kv_specs for t in mine if t.donate)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_kv_table_is_the_references(targets, family):
    from repro.analysis.targets import build_family_targets as jtargets
    from repro.analysis.targets import make_audit_mesh as jmesh

    want = {t.name: dict(t.kv_specs) for t in jtargets(family, mesh=jmesh())}
    compared = 0
    for t in targets:
        ref = want.get(t.name)
        if t.family != family or t.mesh is None or not ref:
            continue
        for path, spec in t.kv_specs:
            # the reference keys a stack's slice by shape; the port keys
            # the stacked leaf, whose first (stack) axis is unsplit
            assert spec[0] is None
            assert spec[1:] in ref.values(), (t.name, path, spec, ref)
            compared += 1
    assert compared >= 8


@pytest.mark.parametrize("rule", sorted(fixtures.GRAPH_FIXTURES))
def test_graph_fixture_fires(rule):
    target = fixtures.GRAPH_FIXTURES[rule]()
    found = {v.rule for v in audit_target(target)}
    assert rule.split("/")[0] in found, found


def test_upcast_site_attribution():
    (v,) = [v for v in audit_target(fixtures.bad_upcast())
            if v.rule == "f32-upcast-allowlist"]
    assert v.file == "src/repro_torch/analysis/fixtures.py"
    line = (ROOT / v.file).read_text().splitlines()[v.line - 1]
    assert "x.float()" in line and "in fn" in v.provenance


@pytest.mark.parametrize("rule", sorted(fixtures.LINT_FIXTURES))
def test_lint_fixture_fires(rule):
    path, src = fixtures.LINT_FIXTURES[rule]
    assert rule.split("/")[0] in {v.rule for v in lint_source(path, src)}


@pytest.mark.parametrize("name", sorted(fixtures.CLEAN_LINT_FIXTURES))
def test_lint_near_miss_clean(name):
    path, src = fixtures.CLEAN_LINT_FIXTURES[name]
    assert lint_source(path, src) == []


def test_every_rule_has_a_fixture():
    covered = {r.split("/")[0] for r in fixtures.GRAPH_FIXTURES} \
        | {r.split("/")[0] for r in fixtures.LINT_FIXTURES} \
        | set(fixtures.COST_FIXTURES) \
        | {"lint-dead-module"}      # test_census_on_a_temporary_tree
    assert covered == set(RULES)


def test_port_tree_lints_clean():
    violations, n_files = run_lint(str(ROOT))
    assert [v.format() for v in violations] == []
    assert n_files > 100


def test_census_on_a_temporary_tree(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "sub").mkdir(parents=True)
    (tmp_path / "tests").mkdir()
    for rel, text in {
            "__init__.py": "",
            "sub/__init__.py": "",
            "sub/used.py": "X = 1\n",
            "sub/dead.py": "Y = 2\n",
            "cli.py": "if __name__ == '__main__':\n    pass\n",
            "late.py": "Z = 3\n"}.items():
        (pkg / rel).write_text(text)
    (tmp_path / "tests" / "test_x.py").write_text(
        "from repro_torch.sub import used\n")
    (tmp_path / "smoke.py").write_text(
        "def main():\n    import repro_torch.late\n")
    dead = [v.file for v in dead_module_census(str(tmp_path))]
    assert dead == [os.path.join("src", "repro_torch", "sub", "dead.py")]


def test_records_validate_and_corruption_fails():
    schema = _schema()
    targets = fixtures.GRAPH_FIXTURES["no-host-transfer"]()
    violations = audit_target(targets)
    v1 = build_report(violations, targets_audited=1, files_linted=3,
                      config={"package": "repro_torch"})
    assert schema.validate(v1) == []
    bad = dict(v1, summary=dict(v1["summary"], violations=0))
    assert schema.validate(bad) != []

    from repro_torch.analysis.cost_audit import (cost_record, count_target,
                                                 reconcile_target)
    target, analytic = fixtures.drifting_cost()
    cost = count_target(target)
    drift, dv = reconcile_target(target, cost, analytic)
    v2 = build_cost_report([cost_record(target, cost, analytic, drift)], dv,
                           config={"package": "repro_torch"})
    assert schema.validate(v2) == [] and v2["summary"]["violations"] == 1
    bad = dict(v2, summary=dict(v2["summary"], targets_drift_checked=0))
    assert schema.validate(bad) != []
    lied = dict(v2, targets=[dict(v2["targets"][0],
                                  drift={"flops": 0.0})])
    assert any("does not equal" in e for e in schema.validate(lied))
