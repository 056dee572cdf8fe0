"""``tools/smoke_phases``: a checkout's ``chip_smoke.py`` runs from its own
directory, and each phase that ``main`` calls is timed once, the phases it
calls in turn counted inside it."""

import json

from deeplearning4j_tpu_torch.tools import smoke_phases

FAKE_SMOKE = '''
import os, time

def phase_inner():
    time.sleep(0.05)

def phase_outer():
    phase_inner()
    time.sleep(0.05)

def phase_again():
    time.sleep(0.01)

def main():
    assert os.path.exists("chip_smoke.py")
    phase_outer()
    phase_again()
    phase_again()
    print("{}")
    return int(os.environ.get("FAKE_RC", "0"))
'''


def _checkout(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(FAKE_SMOKE)
    return str(tmp_path)


def test_phases_are_timed_as_main_calls_them(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(smoke_phases, "smi_line", lambda: "card, 1 W")
    assert smoke_phases.main([_checkout(tmp_path)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[smoke-phases] ")
    row = json.loads(line[len("[smoke-phases] "):])
    assert row["rc"] == 0 and row["card"] == "card, 1 W"
    assert list(row["phases"]) == ["phase_outer", "phase_again"]
    assert row["phases"]["phase_outer"] >= 0.1
    assert row["phases"]["phase_again"] >= 0.02
    assert row["seconds"] >= row["main_seconds"] >= 0.12


def test_a_failing_run_gives_its_exit_code(tmp_path, monkeypatch):
    monkeypatch.setattr(smoke_phases, "smi_line", lambda: "card, 1 W")
    monkeypatch.setenv("FAKE_RC", "3")
    row = smoke_phases.run(_checkout(tmp_path))
    assert row["rc"] == 3 and list(row["phases"]) == ["phase_outer",
                                                      "phase_again"]
    assert smoke_phases.main([_checkout(tmp_path)]) == 3


def test_chip_smoke_main_calls_every_phase_it_defines():
    """The repository's ``chip_smoke.py``: every ``phase_*`` it defines is
    called from ``main`` (so ``smoke_phases`` times it), this slice's
    import and SameDiff phases among them, in the docstring's order."""
    import ast
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    tree = ast.parse(open(path).read())
    defined = {f.name for f in tree.body if isinstance(f, ast.FunctionDef)
               and f.name.startswith("phase_")}
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef)
                and f.name == "main")
    called = [n.func.id for n in ast.walk(main) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Name)
              and n.func.id.startswith("phase_")]
    assert set(called) == defined
    new = ["phase_import", "phase_sd_control", "phase_bert_bf16_fit",
           "phase_bert_remat", "phase_bert_eval"]
    assert [c for c in called if c in new] == new
    doc = ast.get_docstring(tree)
    for tag in ("import:", "sd-control:", "bert-bf16-fit:", "bert-remat:",
                "bert-eval:"):
        assert tag in doc, tag
