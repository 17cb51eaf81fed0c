"""bench.py is the headline metric: it must name the device it measured
and refuse to time anything but a GPU; on a GPU with the bundled assets,
its whole path (scene + cubemap load, warm-up, on-device ray accounting,
JSON output) runs at a tiny size."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))


def test_bench_refuses_cpu():
    import bench

    with pytest.raises(SystemExit, match="no GPU"):
        bench.main(width=32, height=24, n_frames=1, full_spp_budget_s=0.0)


@pytest.mark.gpu
def test_bench_main_smoke(gpu_device, reference_assets, capsys):
    import bench

    # full_spp_budget_s=0 keeps the smoke test at n_frames (the full
    # 256-spp accumulation is 128 frames — a measurement, not a smoke test)
    bench.main(width=64, height=48, n_frames=2, full_spp_budget_s=0.0)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(out)
    assert rec["unit"] == "Mrays/s"
    assert rec["value"] > 0
    assert rec["wall_clock_256spp_s"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 100.0, 4)
    assert rec["device"]["platform"] == "gpu"
