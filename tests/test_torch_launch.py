"""``python -m repro_torch.launch.serve`` on the CPU: every mode exits 0 and
prints the reference launcher's line shapes (``repro/launch/serve.py``);
the observability flags write files that the port's ``checkmetrics``
(``python -m repro_torch.runtime.export``) accepts; ``--strict`` serves
with the hot-path guard on; a model too large for the card is refused by
name."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as launch
from repro_torch.runtime import parse_openmetrics

ROOT = Path(__file__).resolve().parents[1]
LAT = r"p50=[\d.]+ms p95=[\d.]+ms p99=[\d.]+ms"


def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


@pytest.mark.parametrize("mode,lines", [
    ([], [r"^\[serve/sync\] gemma3-1b: 4 reqs, 32 tokens, [\d.]+ tok/s \(\d+ fused steps, "
          r"mean occupancy [\d.]+\)$",
          rf"^\[telemetry\] queue_wait {LAT} \| prefill {LAT} \| decode_step {LAT} \| e2e {LAT}$"]),
    (["--async", "--arch", "starcoder2-3b", "--policy", "sjf"],
     [r"^\[serve/async\] starcoder2-3b: 4 reqs, 32 tokens, [\d.]+ tok/s",
      rf"^\[telemetry\] queue_wait {LAT} \| prefill {LAT} \| decode_step {LAT}"]),
    (["--fleet", "2", "--tenants", "free:1,paid:4", "--deadline-s", "30", "--routing",
      "round_robin"],
     [r"^\[serve/fleet\] gemma3-1b: 2 engines \(round_robin\), 4 reqs done, 0 shed, 32 "
      r"tokens, [\d.]+ tok/s, 0 restarts$",
      rf"^\[tenant free\] submitted=2 completed=2 shed_deadline=0 shed_queue_full=0 \| "
      rf"sched_wait {LAT} \| e2e {LAT}$",
      r"^\[tenant paid\] submitted=2",
      rf"^\[engine decode0\] queue_wait {LAT} \| e2e {LAT}$", r"^\[engine decode1\] ",
      rf"^\[fleet\] queue_wait {LAT} \| e2e {LAT}$"]),
    (["--online"],
     [r"^\[serve/online\] 96 feedback \+ 32 inference in [\d.]+s; window acc [\d.]+"
      r"( \(baseline [\d.]+\))?$",
      rf"^\[telemetry\] queue_wait {LAT} \| update {LAT} \| e2e {LAT} \| online updates=\d+ "
      r"merges=\d+ rollbacks=\d+ drift=\d+$"]),
], ids=["smoke", "async", "fleet", "online"])
def test_modes_print_the_reference_lines(mode, lines):
    r = _run("repro_torch.launch.serve", "--device", "cpu", *mode)
    assert r.returncode == 0, r.stderr
    out = r.stdout.splitlines()
    for pattern in lines:
        assert any(re.search(pattern, line) for line in out), (pattern, r.stdout)
    assert any(re.match(r"^\[metrics\] rendered exposition: \d+ families, \d+ samples "
                        r"\(valid OpenMetrics\)$", line) for line in out)


def test_observability_files_pass_checkmetrics(tmp_path, capsys):
    dump, trace, journal = tmp_path / "m.txt", tmp_path / "t.json", tmp_path / "j.jsonl"
    launch.main(["--device", "cpu", "--async", "--requests", "3", "--max-new", "4",
                 "--buckets", "8", "16", "--metrics-dump", str(dump), "--trace-json",
                 str(trace), "--journal", str(journal), "--metrics-json",
                 "--metrics-port", "0"])
    out = capsys.readouterr().out
    assert "[serve/async] gemma3-1b: 3 reqs, 12 tokens" in out
    assert re.search(r"\[metrics\] scraped http://127\.0\.0\.1:\d+/metrics: \d+ families", out)
    assert re.search(r"\[trace\] wrote \d+ events covering 3 trace ids", out)
    fams = parse_openmetrics(dump.read_text())
    assert fams["repro_prefill_seconds"]["type"] == "summary"
    assert fams["repro_decode_step_seconds"]["type"] == "summary"
    snap = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert snap["prefill_s"]["count"] == 3 and snap["completed"] == 3
    spans = {e["name"] for e in json.loads(trace.read_text())["traceEvents"] if e["ph"] == "X"}
    assert {"plan.prefill", "plan.decode_step", "engine.inbox", "engine.e2e"} <= spans
    r = _run("repro_torch.runtime.export", str(dump), "--require", "repro_prefill_seconds",
             "--require", "repro_decode_step_seconds", "--trace", str(trace),
             "--expect-trace-id", "1", timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("checkmetrics: OK")


def test_strict_is_refused_by_name(capsys, monkeypatch):
    """``--strict`` is accepted and runs on the CPU: the launcher's service
    binds ServiceConfig(strict=True), and its line is the plain one."""
    from repro_torch.runtime import service

    seen = []
    real = service.serve_model

    def spy(model, config=None):
        seen.append(config.strict)
        return real(model, config)

    monkeypatch.setattr(launch, "serve_model", spy)
    launch.main(["--device", "cpu", "--strict", "--requests", "2", "--max-new", "3"])
    assert seen == [True]
    out = capsys.readouterr().out
    assert re.search(r"^\[serve/sync\] gemma3-1b: 2 reqs, 6 tokens", out, re.M), out


def test_full_refuses_a_model_larger_than_the_card(monkeypatch):
    """--full names the bytes a config's parameters need, before any
    allocation, when the card holds fewer (here yi-9b in bf16 against a
    16 GiB card)."""
    class Props:
        total_memory = 16 << 30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "a 16 GB card")
    cfg = get_config("yi-9b")
    need = cfg.param_count() * 2
    with pytest.raises(SystemExit, match=f"{need} bytes in bfloat16.*{16 << 30} bytes"):
        launch.load_model(cfg, torch.device("cuda", 0))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-236b"])
def test_serves_the_moe_archs(capsys, arch):
    """Both MoE archs (GQA and MLA attention) serve through the launcher at
    their smoke configs."""
    launch.main(["--device", "cpu", "--arch", arch, "--requests", "3", "--max-new", "3",
                 "--max-batch", "2", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert re.search(rf"^\[serve/sync\] {arch}: 3 reqs, 9 tokens", out, re.M), out


def test_full_moe_archs_on_an_80_gb_card(monkeypatch):
    """On an 80 GB card --full refuses deepseek-v2-236b by its bytes
    (235.7 B parameters, 471.5 GB in bf16); moonshot-v1-16b-a3b's 28.4 B
    (56.8 GB) fit, so the check lets it through."""
    class Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "an 80 GB card")
    big = get_config("deepseek-v2-236b")
    with pytest.raises(SystemExit, match=f"{big.param_count() * 2} bytes in bfloat16"):
        launch.load_model(big, torch.device("cuda", 0))
    assert get_config("moonshot-v1-16b-a3b").param_count() * 2 < Props.total_memory


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b", "internvl2-1b"])
def test_serves_the_state_space_and_vlm_archs(capsys, arch):
    """The ssm, hybrid and vlm archs serve through the launcher at their
    smoke configs (the stateful two at exact-length prefill, buckets
    given or not)."""
    launch.main(["--device", "cpu", "--arch", arch, "--requests", "3", "--max-new", "3",
                 "--max-batch", "2", "--max-seq", "32", "--buckets", "16"])
    out = capsys.readouterr().out
    assert re.search(rf"^\[serve/sync\] {arch}: 3 reqs, 9 tokens", out, re.M), out

