"""Continuous batching, the server and the CLI on a mesh, in spawned gloo
ranks on the CPU: the scheduler on tp=2 and on dp=2 gives the same token
streams as the port's single-device scheduler (as tests/test_scheduler_mesh.py:38
asserts for JAX's), the MoE scheduler on ep=2 completes and repeats itself,
the server with --mesh 1,1,2 answers a completion as the single-device
server does, and `python -m torch.distributed.run` runs the CLI with
-M 1,1,2 -d cpu to the single process's output. The leader rank owns the
scheduler and broadcasts each step to the other, which follows."""

import os
import subprocess
import sys

import pytest
import torch

from yalm_tpu_torch import cli
from yalm_tpu_torch import server as srv
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.models.fast import load_fast_weights
from yalm_tpu_torch.scheduler import Request, Scheduler
from yalm_tpu_torch.server import ServingEngine
from yalm_tpu_torch.utils.testing import run_ranks, synth_checkpoint, tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "yalm_tpu_torch.utils.testing:mesh_cases"


def kw(**overrides):
    base = dict(dim=256, hidden_dim=512, head_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                vocab_size=512, max_seq_len=64, rotary_dim=128, qkv_clip=30.0,
                weight_dtype="fp8")
    base.update(overrides)
    return base


# greedy and sampled, one prompt past the window (ring hydration), more
# requests than lanes
REQUESTS = [dict(prompt_tokens=[1, 5 + i, 9] + list(range(40, 40 + 5 * i)),
                 max_new_tokens=6 + i % 3, temperature=0.0 if i % 2 == 0 else 0.8,
                 top_p=0.9 if i % 2 else 1.0, seed=30 + i) for i in range(7)]
REQUESTS.append(dict(prompt_tokens=[1] + list(range(100, 170)), max_new_tokens=5,
                     temperature=0.0, seed=40))
PROMPT = "hello world"


def single_streams(path, batch=4):
    yf = read_yalm(path)
    from yalm_tpu_torch.config import ModelConfig
    cfg = ModelConfig.from_metadata(yf.metadata)
    sched = Scheduler(cfg, load_fast_weights(yf, cfg, "cpu"), batch=batch, device="cpu")
    yf.close()
    reqs = [Request(**r) for r in REQUESTS]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [r.generated for r in reqs]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sched_mesh")
    dense, moe = str(d / "m.yalm"), str(d / "moe.yalm")
    synth_checkpoint(dense, tiny_config(**kw()), seed=23)
    synth_checkpoint(moe, tiny_config(**kw(n_experts=4, n_experts_active=2)), seed=24)
    cases = [dict(op="scheduler", path=dense, mesh=(1, 1, 2), batch=4, requests=REQUESTS),
             dict(op="scheduler", path=dense, mesh=(2, 1, 1), batch=4, requests=REQUESTS),
             dict(op="scheduler", path=moe, mesh=(1, 2, 1), batch=4, requests=REQUESTS),
             dict(op="scheduler", path=moe, mesh=(1, 2, 1), batch=4, requests=REQUESTS),
             dict(op="server", path=dense, mesh=(1, 1, 2), prompt=PROMPT, max_tokens=8)]
    res = run_ranks(WORKER, 2, {"cases": cases}, str(d / "w2"), timeout=240)
    return dense, moe, res


@pytest.mark.parametrize("k", [0, 1], ids=["tp2", "dp2"])
def test_scheduler_on_mesh_matches_single_device(world, k):
    """tp=2 (heads, hidden and vocab split) and dp=2 (lanes split): every
    stream, greedy and sampled, the single-device scheduler's."""
    dense, _, res = world
    assert res[1][k] is None   # the follower returns nothing
    assert res[0][k] == single_streams(dense)


def test_moe_scheduler_on_ep_completes_and_repeats(world):
    """ep=2: every request completes its tokens, and a second run gives the
    same streams (scheduler_mesh.py's MoE end to end)."""
    _, moe, res = world
    got = res[0][2]
    assert [len(g) for g in got] == [r["max_new_tokens"] for r in REQUESTS]
    assert res[0][3] == got
    assert sum(a == b for g, s in zip(got, single_streams(moe)) for a, b in zip(g, s)) \
        >= 0.8 * sum(map(len, got))


def test_server_on_mesh_answers_as_one_device(world):
    """--mesh 1,1,2's engine serves a completion over HTTP, the same text
    the single-device server gives."""
    dense, _, res = world
    eng = ServingEngine.from_checkpoint(dense, batch=4, device="cpu")
    try:
        want = eng.complete(PROMPT, max_tokens=8, temperature=0.0)
    finally:
        eng.close()
    assert res[0][4] == want and res[1][4] is None


def test_cli_on_mesh_under_torchrun(world, capsysbinary):
    """python -m torch.distributed.run --nproc-per-node 2 runs -M 1,1,2 -d
    cpu (gloo): rank 0 prints the single process's completion; -M with dp
    != 1 exits with JAX's message."""
    dense = world[0]
    args = [dense, "-d", "cpu", "-m", "completion", "-i", PROMPT, "-n", "8", "-t", "0"]
    two = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", "2", "-m", "yalm_tpu_torch.cli", *args,
                            "-M", "1,1,2"], cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, env=dict(os.environ, OMP_NUM_THREADS="1"))
    cli.main(args)   # the single process, while the two ranks run
    one = capsysbinary.readouterr().out
    out, err = two.communicate(timeout=180)
    assert two.returncode == 0, err.decode()[-3000:]

    def text(out):   # the generation: after the encoding's stats line, before its own
        return out.split(b"Generation stats")[0].split(b"Encoding stats")[1].split(b"\n", 1)[1]
    assert text(out) == text(one)
    assert out.count(b"Generation stats") == 1   # rank 0 alone prints
    with pytest.raises(SystemExit, match="dp=1"):
        cli.main([dense, "-d", "cpu", "-M", "2,1,1", "-i", PROMPT])


def test_server_mesh_flags(world, capsys):
    """--mesh's checks (server.py:660-703): the batch splits over dp, and
    the world (one process per device) is the mesh."""
    dense = world[0]
    with pytest.raises(SystemExit):
        srv.main([dense, "--device", "cpu", "--mesh", "2,1,1", "--batch", "3"])
    assert "divisible by dp=2" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        srv.main([dense, "--device", "cpu", "--mesh", "1,1,2"])
    assert "wants 2 processes" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()
