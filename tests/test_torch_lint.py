"""The repository's lint (``tools/repro_lint.py``: lock discipline, span
closure, pass annotations) over the PyTorch port, ``src/repro_torch``.

The lint's default surface is the JAX package and the tools; this holds the
port to the same rules, so that L002 guards every ``TRACER.start`` there
(each paired with a ``finish`` on every path)."""

from pathlib import Path

from tools.repro_lint import main

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_the_port_is_lint_clean(capsys):
    rc = main([str(PORT)])
    out = capsys.readouterr().out
    assert rc == 0, f"repro_lint found violations in the port:\n{out}"
    assert "repro_lint: clean" in out
