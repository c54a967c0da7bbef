"""The port's elastic agent as real processes, on the CPU: `python -m
mxnet_tpu_torch.elastic.agent --ctx cpu` workers under an in-process
`ElasticCoordinator`.

One job runs uninterrupted with one worker. Another starts with two,
and one of them kills itself by SIGKILL after its sixth step
(MXNET_TPU_FAULT_INJECT=kill:step:6): it exits -9, the survivor finishes
the job alone, its final parameters equal the uninterrupted run's with
`np.array_equal`, and the two workers' consumed logs hold every (epoch,
shard, step) batch exactly once with the sampler's indices. An agent
started with no card and no `--ctx cpu` exits non-zero before its hello.
Every child runs one torch thread (OMP_NUM_THREADS=1), so the workers'
CPU gradients have the same bits in every process.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.elastic import ElasticCoordinator
from mxnet_tpu_torch.elastic import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = "mxnet_tpu_torch.elastic.ci_job:build"
KILL_STEP = 6


def _env(**extra):
    env = dict(os.environ)
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MXNET_EXEC_CACHE_DIR="")
    for var in ("MXNET_TPU_FAULT_INJECT", "MXNET_ELASTIC_LOGICAL_SHARDS",
                "MXNET_ELASTIC_MIN_WORLD", "MXNET_ELASTIC_PORT"):
        env.pop(var, None)
    env.update(extra)
    return env


def _agent(port, name, log, *extra, env=None):
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.elastic.agent",
           "--connect", f"127.0.0.1:{port}", "--entry", ENTRY,
           "--name", name, "--consumed-log", log, *extra]
    return subprocess.Popen(cmd, cwd=ROOT, env=env or _env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, timeout=120):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def _consumed(logs):
    seen = {}
    for path in logs:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                key = (rec["epoch"], rec["shard"], rec["step"])
                assert key not in seen, f"{key} consumed twice"
                seen[key] = rec["idx"]
    return seen


def test_sigkilled_worker_survivor_bit_identical(tmp_path):
    spec = ttrainer.load_entry(ENTRY)({})
    ref = ElasticCoordinator(ENTRY, {}, name="p_ref",
                             initial_world=1).start()
    job = ElasticCoordinator(ENTRY, {}, name="p_kill", initial_world=2,
                             workdir=str(tmp_path / "job")).start()
    procs = {}
    try:
        logs = {n: str(tmp_path / f"{n}.jsonl")
                for n in ("ref", "victim", "survivor", "nocard")}
        procs["ref"] = _agent(ref.port, "ref", logs["ref"], "--ctx", "cpu")
        procs["victim"] = _agent(
            job.port, "victim", logs["victim"], "--ctx", "cpu",
            env=_env(MXNET_TPU_FAULT_INJECT=f"kill:step:{KILL_STEP}"))
        procs["survivor"] = _agent(job.port, "survivor", logs["survivor"],
                                   "--ctx", "cpu")
        if not torch.cuda.is_available():
            procs["nocard"] = _agent(ref.port, "nocard", logs["nocard"])
        results = {n: _finish(p) for n, p in procs.items()}
        assert ref.wait(60), ref.status()
        assert job.wait(60), job.status()
        want, got = ref.final_params(), job.final_params()
        snap = job._stats.snapshot()
        ref_members = ref.status()["members"]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
        ref.stop()
        job.stop()
    detail = {n: (rc, err[-2000:]) for n, (rc, _, err) in results.items()}
    assert results["victim"][0] == -9, detail
    for n in ("ref", "survivor"):
        rc, out, _ = results[n]
        assert rc == 0 and json.loads(out.strip().splitlines()[-1]) == \
            {"result": "complete"}, detail
    if "nocard" in results:
        rc, _, err = results["nocard"]
        assert rc != 0 and "no CUDA device" in err, detail
        assert [m["pid"] for m in ref_members] == [procs["ref"].pid]
    for n in want:
        assert np.array_equal(want[n], got[n]), n
    assert snap["transitions_shrink"] == 1 and snap["digest_mismatches"] == 0
    assert snap["reshard_bytes_moved"] < snap["reshard_bytes_full_restore"]
    with open(logs["victim"]) as f:
        assert len(f.read().splitlines()) == KILL_STEP   # one shard a step
    # exactly once, with the one-member sampler's indices, in each job
    for job_logs in ([logs["ref"]], [logs["victim"], logs["survivor"]]):
        seen = _consumed(job_logs)
        truth = spec.make_sampler()
        for epoch in range(spec.epochs):
            truth.set_epoch(epoch)
            truth.set_membership(0, 1)
            for p in range(spec.batches_per_epoch):
                for s in range(spec.logical_shards):
                    assert seen.pop((epoch, s, p)) == \
                        truth.shard_batch(s, p).tolist(), (epoch, s, p)
        assert not seen
