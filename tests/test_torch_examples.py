"""``examples/serve_semantic_pipeline_torch.py`` on the CPU against the
reference example: both run in subprocesses (at once), and the port's
printed counts must be the reference's where the weights do not decide
them (generations, LM calls of ``sem_map``, records the proxy scores, hits
of ``sem_search``).  The models' weights are drawn by each framework from
its own generator, so the cascade's decisions and the generated texts
part."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _counts(out: str) -> dict:
    m = re.search(r"sem_map over engine: (\d+) generations .*\((\d+) LM calls", out)
    f = re.search(r"sem_filter cascade: (\d+) pass .*\(proxy scored (\d+), "
                  r"oracle confirmed (\d+)\)", out)
    s = re.search(r"sem_search top-3: (\[.*\])", out)
    e = re.search(r"lm_calls=(\d+)", out)
    assert m and f and s and e, out[-3000:]
    return {"generations": int(m[1]), "map_calls": int(m[2]), "passed": int(f[1]),
            "proxy": int(f[2]), "oracle": int(f[3]), "hits": len(ast.literal_eval(s[1])),
            "lm_calls": int(e[1])}


def test_serve_semantic_pipeline_twin_matches_the_reference_example():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    runs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples" / script), *extra],
                                   env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
            for name, script, extra in [
                ("port", "serve_semantic_pipeline_torch.py", ["--device", "cpu"]),
                ("ref", "serve_semantic_pipeline.py", [])]}
    outs = {}
    for name, p in runs.items():
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
        outs[name] = out
    assert "(PyTorch, cpu)" in outs["port"]
    got, want = _counts(outs["port"]), _counts(outs["ref"])
    for k in ("generations", "map_calls", "proxy", "hits"):
        assert got[k] == want[k], (k, got, want)
    assert got["generations"] == 24 and got["hits"] == 3
    assert 0 <= got["passed"] <= 24 and got["oracle"] <= got["proxy"]
    assert got["lm_calls"] >= got["map_calls"]
