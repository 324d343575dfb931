"""Ranks of a gloo group on the CPU for the port's sequence-parallel tests.

``run_ranks(cases, world, workdir)`` starts ``world`` processes of this file,

    python tests/_torch_sp_worker.py RANK WORLD INIT_FILE CASES_FILE OUT_DIR

each one rank of a gloo group (``seq_group(device="cpu")`` over a FileStore
in ``workdir``, so parallel test runs share no port). Every rank loads the
cases (a ``torch.save``'d list of dicts of tensors and numbers), runs each
on the sub-group of the first ``case["world"]`` ranks, and writes what it
computed to OUT_DIR/rank{RANK}.pt; ``run_ranks`` returns those dicts in
rank order. A test module starts its ranks once and runs every case in them.

The workers import torch and the port only, never JAX or the conftest.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def run_ranks(cases: list, world: int, workdir: Path, timeout: float = 240.0) -> list:
    """Run ``cases`` on ``world`` worker ranks; per-rank result dicts."""
    workdir = Path(workdir)
    cases_file, out_dir = workdir / "cases.pt", workdir / "out"
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(cases, cases_file)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, logs = [], []
    try:
        for rank in range(world):
            log = open(workdir / f"rank{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(rank), str(world), str(workdir / "store"),
                 str(cases_file), str(out_dir)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO,
            ))
        for proc in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tail = (workdir / f"rank{failed[0]}.log").read_text()[-4000:]
        raise RuntimeError(f"ranks {failed} of {world} failed; rank {failed[0]}:\n{tail}")
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(world)]


def _ring(case, group):
    from tpdm_tpu_torch.parallel.sp_attention import make_ring_attention

    q, k, v = case["q"], case["k"], case["v"]
    n_local = q.shape[2] // group.size
    rows = slice(group.rank * n_local, (group.rank + 1) * n_local)
    ring = make_ring_attention(group, kv_len=case.get("kv_len"))
    return {"o": ring(q[:, :, rows].contiguous(), k[:, :, rows].contiguous(),
                      v[:, :, rows].contiguous())}


def _models(case, group):
    from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from tpdm_tpu_torch.models.tpm import TimePredictor
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig

    mmdit = MMDiT(MMDiTConfig.toy(seq_group=group, **case["mmdit_cfg"]))
    mmdit.load_state_dict(case["mmdit"])
    out = [mmdit.eval()]
    if "tpm" in case:
        tpm = TimePredictor(**case["tpm_kw"])
        tpm.load_state_dict(case["tpm"])
        out.append(tpm.eval())
    if "vae" in case:
        vae = VAE(VAEConfig.toy(**case["vae_cfg"]))
        vae.load_state_dict(case["vae"])
        out.append(vae.eval())
    return out


def _mmdit(case, group):
    (mmdit,) = _models(case, group)
    with torch.no_grad():
        vel, temb, h1, h2 = mmdit(*case["inputs"])
    return {"velocity": vel, "temb": temb, "h1": h1, "h2": h2}


def _sample(case, group):
    from tpdm_tpu_torch.pipeline.denoise import make_cfg_denoise_fn
    from tpdm_tpu_torch.pipeline.sampler import SamplerConfig, adaptive_sample

    mmdit, tpm = _models(case, group)
    c = mmdit.config
    grid = c.sample_size // c.patch_size
    denoise = make_cfg_denoise_fn(mmdit, case["pe"], case["pp"], case["gs"], grid, c.patch_size)
    out = adaptive_sample(denoise, tpm, case["lat"], None, SamplerConfig(**case["sampler"]),
                          group=group)
    return {"num_steps": out.num_steps, "sigmas": out.sigmas,
            "final_latents": out.final_latents, "prob_masks": out.prob_masks}


def _generate(case, group):
    from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline

    mmdit, tpm, vae = _models(case, group)
    # rank 0's seed decides the initial latents: the other ranks' are broadcast over
    seed = case["seed"] + group.rank
    res = TPDMPipeline(mmdit, tpm, vae, min_sigma=0.01).generate(
        *case["embeds"], seed=seed, **case["kw"])
    return {"images": torch.from_numpy(res.images), "num_steps": res.num_steps,
            "sigmas": torch.from_numpy(res.sigmas)}


RUNNERS = {"ring": _ring, "mmdit": _mmdit, "sample": _sample, "generate": _generate}


def main(rank: int, world: int, store: str, cases_file: str, out_dir: str) -> None:
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from tpdm_tpu_torch.parallel.mesh import seq_group

    world_group = seq_group("cpu", rank=rank, world_size=world, init_method=f"file://{store}")
    cases = torch.load(cases_file)
    # every rank creates every sub-group, in one order, as new_group requires
    sizes = sorted({c["world"] for c in cases if c["world"] < world})
    subgroups = {w: dist.new_group(list(range(w))) for w in sizes}
    groups = {world: world_group}
    for w, g in subgroups.items():
        if rank < w:
            groups[w] = seq_group("cpu", group=g)
    results = {}
    for case in cases:
        if rank < case["world"]:
            results[case["name"]] = RUNNERS[case["kind"]](case, groups[case["world"]])
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
