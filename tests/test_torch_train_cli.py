"""tpdm_tpu_torch's training entry point and its parts against the JAX
package: ``instantiate``, the prompt datasets and collators, the
TensorBoard event files, the CLI's flags, and the eval callback's record
on the same toy weights; then ``python -m tpdm_tpu_torch.train.main``
in-process on the CPU (eval, TensorBoard, profiler, checkpoints, resume)
and its refusal without a card. The eval rollout is compiled once by JAX
at a few steps (``EVAL_STEPS``); its fp32 bound is ``_torch_parity``'s.
"""

import dataclasses
import functools
import io
import json
import sys
import tarfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import close, drawn_models, t
from tpdm_tpu.data import collate as jcollate
from tpdm_tpu.data import datasets as jdatasets
from tpdm_tpu.train import RLOOConfig as JRLOOConfig
from tpdm_tpu.train import TPDMAgent as JTPDMAgent
from tpdm_tpu.train.callbacks import EvalVisualizationCallback as JEvalCallback
from tpdm_tpu.utils import instantiate as jinst
from tpdm_tpu.utils import tb_writer as jtb
from tpdm_tpu_torch.data import collate, datasets
from tpdm_tpu_torch.models.tpm import TimePredictor
from tpdm_tpu_torch.models.vae import VAE, VAEConfig
from tpdm_tpu_torch.pipeline.pipeline import decode_latents
from tpdm_tpu_torch.train import RLOOConfig, RLOOTrainer, TPDMAgent
from tpdm_tpu_torch.train import main as cli
from tpdm_tpu_torch.train.builders import build_toy_agent, build_toy_reward
from tpdm_tpu_torch.train.callbacks import (
    EvalVisualizationCallback,
    ProfilerCallback,
    TensorBoardCallback,
    TimeBudgetCallback,
)
from tpdm_tpu_torch.utils import instantiate as inst
from tpdm_tpu_torch.utils import tb_writer as tb

EVAL_STEPS = 6
REPO = Path(__file__).resolve().parents[1]
TOY = "configs/torch"


# ---------------------------------------------------------------------------
# instantiate
# ---------------------------------------------------------------------------

_NESTED = {
    "_target_": "collections.OrderedDict",
    "delta": {"_target_": "datetime.timedelta", "days": 2, "hours": 3},
    "frac": {"_target_": "fractions.Fraction", "numerator": 3, "denominator": 4},
    "items": [{"_target_": "decimal.Decimal", "value": "1.5"}, 7, "x"],
    "plain": {"a": 1, "b": [True, None]},
}
_PARTIAL = {"_target_": "textwrap.shorten", "_partial_": True, "width": 12,
            "placeholder": {"_target_": "builtins.str", "object": " ..."}}


@pytest.mark.parametrize("cfg,overrides", [
    (_NESTED, {}),
    (_NESTED, {"extra": 3}),
    ({"_target_": "fractions.Fraction", "numerator": 1, "denominator": 3}, {"numerator": 2}),
    ([{"_target_": "datetime.date", "year": 2020, "month": 1, "day": 2}, {"k": [1.5]}], {}),
], ids=["nested", "override", "override_arg", "list"])
def test_instantiate_matches_jax(cfg, overrides):
    assert inst.instantiate(cfg, **overrides) == jinst.instantiate(cfg, **overrides)


def test_instantiate_partial_and_file_match_jax(tmp_path):
    ours, ref = inst.instantiate(_PARTIAL), jinst.instantiate(_PARTIAL)
    assert isinstance(ours, functools.partial) and ours.func is ref.func
    assert ours.keywords == ref.keywords
    text = "the quick brown fox jumps over the lazy dog"
    assert ours(text) == ref(text)
    path = tmp_path / "c.yaml"
    path.write_text("_target_: fractions.Fraction\nnumerator: 5\ndenominator: 10\n")
    assert inst.instantiate_file(str(path), denominator=20) == jinst.instantiate_file(
        str(path), denominator=20)


def test_port_yamls_load_as_jax_loads_them():
    paths = sorted((REPO / TOY).rglob("*.yaml"))
    assert len(paths) == 5  # with models/sd3_agent.yaml, the pretrained agent
    for p in paths:
        assert inst.load_yaml(str(p)) == jinst.load_yaml(str(p))
    rows = [{"prompt": "The image shows a cat"}, {"prompt": "a dog"}]
    collate_fn = inst.instantiate_file(str(REPO / TOY / "collators" / "json_prompt.yaml"))
    assert collate_fn(rows) == jinst.instantiate_file(
        str(REPO / "configs" / "collators" / "json_prompt.yaml"))(rows)


# ---------------------------------------------------------------------------
# datasets and collators
# ---------------------------------------------------------------------------

def _write_prompt_files(tmp_path):
    array = tmp_path / "array.json"
    array.write_text(json.dumps([{"prompt": f"array prompt {i}", "n": i} for i in range(5)]))
    one = tmp_path / "a_part.jsonl"
    one.write_text("\n".join(json.dumps({"text": f"a {i}"}) for i in range(4)) + "\n\n")
    two = tmp_path / "b_part.jsonl"
    two.write_text("\n".join(json.dumps({"text": f"The image shows b {i}"}) for i in range(3)))
    return array, str(tmp_path / "*_part.jsonl")


@pytest.mark.parametrize("source", ["example", "array", "glob"])
def test_jsonl_dataset_matches_jax(tmp_path, source):
    array, pattern = _write_prompt_files(tmp_path)
    files, kw = {"example": ("example/prompts.jsonl", {}),
                 "array": (str(array), {"seed": 3}),
                 "glob": (pattern, {"seed": 7, "prompt_key": "text"})}[source]
    ours = datasets.JsonlPromptDataset(files, **kw)
    ref = jdatasets.JsonlPromptDataset(files, use_native=False, **kw)
    assert len(ours) == len(ref) > 3
    assert [ours[i] for i in range(len(ours))] == ref.rows
    assert ours.prompt_key == ref.prompt_key
    if source == "example":
        assert collate.json_prompt_collate(ours.rows) == jcollate.json_prompt_collate(ref.rows)


def test_missing_files_raise_like_jax(tmp_path):
    for cls in (datasets.JsonlPromptDataset, datasets.WebDatasetPrompts):
        with pytest.raises(FileNotFoundError, match="no files match"):
            cls(str(tmp_path / "none*.jsonl"))


def test_webdataset_and_collates_match_jax(tmp_path):
    for shard in range(2):
        with tarfile.open(tmp_path / f"shard{shard}.tar", "w") as tar:
            for i in range(5):
                payload = json.dumps({"caption": f"caption {shard}-{i}", "alt": f"alt {i}"})
                for name, data in ((f"{shard}{i:03d}.json", payload.encode()),
                                   (f"{shard}{i:03d}.txt", b"skipped")):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
    kw = dict(data_files=str(tmp_path / "shard*.tar"), buffer_size=3, seed=5)
    ours = list(datasets.WebDatasetPrompts(**kw))
    ref = list(jdatasets.WebDatasetPrompts(**kw))
    assert ours == ref and len(ours) == 10
    assert collate.webdataset_prompt_collate(ours) == jcollate.webdataset_prompt_collate(ref)
    assert (collate.webdataset_prompt_collate(ours, caption_keys=("missing", "alt"))
            == jcollate.webdataset_prompt_collate(ref, caption_keys=("missing", "alt")))
    with pytest.raises(KeyError):
        collate.webdataset_prompt_collate(ours, caption_keys=("missing",))
    assert datasets.DummyPromptDataset(4).rows == jdatasets.DummyPromptDataset(4).rows


# ---------------------------------------------------------------------------
# TensorBoard event files
# ---------------------------------------------------------------------------

_SCALARS = {"loss/policy_avg": -0.125, "eps": 7, "val/ratio": np.float32(1.0000001),
            "lr": 1e-6, "policy/steps_avg": 13.25}


def test_event_encoding_is_byte_identical():
    for step in (0, 1, 300, 2**40):
        assert (tb.encode_scalar_event(step, _SCALARS, 1.5e9 + step)
                == jtb.encode_scalar_event(step, _SCALARS, 1.5e9 + step))
    assert tb.encode_version_event(1234.5) == jtb.encode_version_event(1234.5)
    assert tb.crc32c(b"123456789") == jtb.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_event_files_read_back_through_the_other(tmp_path, writer):
    module, reader = (tb, jtb) if writer == "port" else (jtb, tb)
    with module.EventWriter(str(tmp_path)) as w:
        for step in (1, 2, 5):
            w.add_scalars(step, {**_SCALARS, "skip/bool": True, "skip/str": "x"})
    events = reader.read_scalar_events(w.path)
    assert events == module.read_scalar_events(w.path)
    assert [s for s, _ in events] == [1, 2, 5]
    assert events[0][1] == {k: float(np.float32(v)) for k, v in _SCALARS.items()}


# ---------------------------------------------------------------------------
# The CLI's flags
# ---------------------------------------------------------------------------

def _jax_args(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["main_train.py"] + argv)
    import main_train

    return main_train.parse_args()


_REQUIRED = ["--model_config", "m.yaml", "--reward_model_config", "r.yaml",
             "--train_dataset", "d.yaml"]


def test_parser_takes_every_rloo_flag_with_jax_defaults(monkeypatch):
    ours, ref = cli.build_parser().parse_args(_REQUIRED), _jax_args(monkeypatch, _REQUIRED)
    names = [f.name for f in dataclasses.fields(JRLOOConfig)]
    assert names == [f.name for f in dataclasses.fields(RLOOConfig)]
    for name in names + ["data_collator", "resume_from_checkpoint", "cpu", "profile_updates",
                         "profile_start", "trainer", "multihost", "mesh_shape"]:
        assert getattr(ours, name) == getattr(ref, name), name


def test_parser_values_match_jax(monkeypatch):
    """Every RLOOConfig flag given on the command line parses to the value
    JAX's main hands RLOOConfig (its Optional flags arrive as strings and
    are cast to int there; tpm_param_cap stays a string in JAX)."""
    values = {"exp_name": "run", "seed": "7", "total_episodes": "48", "num_train_epochs": "2.5",
              "learning_rate": "3e-4", "mean_kl": "true", "relative": "false",
              "guidance_scale": "4.5", "save_total_limit": "2", "tpm_param_cap": "30.0",
              "offload_cache": "host", "report_to": "tensorboard", "solver": "ab2"}
    argv = _REQUIRED + [a for k, v in values.items() for a in (f"--{k}", v)]
    ours, ref = cli.build_parser().parse_args(argv), _jax_args(monkeypatch, argv)
    for f in dataclasses.fields(RLOOConfig):
        want = getattr(ref, f.name)
        if isinstance(want, str) and f.default is None:
            want = type(getattr(ours, f.name))(want)
        assert getattr(ours, f.name) == want, f.name
    assert ours.tpm_param_cap == 30.0 and ours.relative is False and ours.mean_kl is True
    assert cli.build_parser().parse_args(_REQUIRED + ["--total_episodes", "none"]).total_episodes is None


@pytest.mark.parametrize("flags,match", [
    (["--trainer", "dpo"], r"item 9\(e\)"),
    (["--trainer", "draft"], r"item 9\(e\)"),
    (["--multihost"], r"item 9\(d\)"),
    (["--mesh_shape", "auto"], r"item 9\(d\)"),
    (["--watchdog_coordinator", "localhost:1234"], "item 14"),
    (["--watchdog_timeout", "5"], "item 14"),
])
def test_unported_flags_raise(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(_REQUIRED + ["--cpu"] + flags)


@pytest.mark.parametrize("value,want", [(None, None), ("false", None), ("None", None),
                                        ("", None), ("TRUE", True), ("out/checkpoint-3",
                                                                     "out/checkpoint-3")])
def test_resume_flag(value, want):
    assert cli._resume_arg(value) == want


# ---------------------------------------------------------------------------
# The eval callback against JAX's on the same toy weights
# ---------------------------------------------------------------------------

def _toy_reward_np(prompts, outputs):
    s = np.tanh(np.asarray(outputs.final_latents, np.float32).mean(axis=(1, 2, 3)))
    return s, s


def test_eval_record_matches_jax(tmp_path):
    models = drawn_models(3, vae=False)
    jm, mvars, tm = models["mmdit"]
    jt, tvars, tt = models["tpm"]
    c = jm.config
    kw = dict(max_inference_steps=28, min_sigma=0.2, guidance_scale=7.0)
    jagent = JTPDMAgent(jm, mvars, JRLOOConfig(**kw), tpm=jt)
    tagent = TPDMAgent(tm, RLOOConfig(**kw), tpm=lambda: TimePredictor(
        in_channels=tt.conv1.in_channels, temb_dim=tt.norm1.linear.in_features,
        conv_out_channels=tt.conv1.out_channels))
    rng = np.random.default_rng(9)
    b = 2
    batch = {
        "prompt": [f"eval prompt {i}" for i in range(b)],
        "prompt_embeds": rng.standard_normal((b, 5, c.joint_attention_dim), np.float32),
        "pooled_prompt_embeds": rng.standard_normal((b, c.pooled_projection_dim), np.float32),
        "negative_prompt_embeds": np.zeros((b, 5, c.joint_attention_dim), np.float32),
        "negative_pooled_prompt_embeds": np.zeros((b, c.pooled_projection_dim), np.float32),
        "latents": rng.standard_normal((b, c.in_channels, c.sample_size, c.sample_size),
                                       np.float32),
    }
    jcb = JEvalCallback(batch, str(tmp_path / "jax"), reward_fn=_toy_reward_np, eval_steps=2,
                        max_inference_steps=EVAL_STEPS)
    tbatch = {k: (v if k == "prompt" else t(v)) for k, v in batch.items()}
    tcb = EvalVisualizationCallback(tbatch, str(tmp_path / "port"), reward_fn=build_toy_reward(),
                                    eval_steps=2, max_inference_steps=EVAL_STEPS)
    for update in (1, 2):
        jcb.on_step_end(types.SimpleNamespace(agent=jagent), update, {}, tvars)
        tcb.on_step_end(types.SimpleNamespace(agent=tagent), update, {}, tt.state_dict())
    assert len(tcb.history) == len(jcb.history) == 1
    ours, ref = tcb.history[0], jcb.history[0]
    assert ours["update"] == ref["update"] == 2
    assert ours["sigmas"].shape == (b, EVAL_STEPS)
    assert ours["nfe"].max() < EVAL_STEPS  # the loop stopped itself
    for name in ("sigmas", "alphas", "betas"):
        close(ours[name], ref[name], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ours["masks"], ref["masks"])
    np.testing.assert_array_equal(ours["nfe"], ref["nfe"])
    assert 1 <= ours["nfe"].min()
    np.testing.assert_allclose(ours["rewards"], ref["rewards"], rtol=1e-5, atol=1e-5)
    assert (tmp_path / "port" / "eval_curves_2.png").is_file()


# ---------------------------------------------------------------------------
# The callbacks on the port's toy trainer
# ---------------------------------------------------------------------------

def _toy_trainer(tmp_path, callbacks=(), **kw):
    cfg = RLOOConfig(**{**dict(per_device_train_batch_size=4, rloo_k=2, max_inference_steps=3,
                               total_episodes=8, output_dir=str(tmp_path)), **kw})
    agent = build_toy_agent(cfg, device="cpu")
    from tpdm_tpu_torch.train.builders import make_prompt_encoder

    return RLOOTrainer(cfg, agent, build_toy_reward(),
                       [{"prompt": f"prompt {i}"} for i in range(4)],
                       collate_fn=make_prompt_encoder(agent, n_txt=5), callbacks=callbacks)


def test_report_to_and_offload_checks():
    with pytest.raises(ValueError, match="report_to"):
        _toy_trainer("unused", report_to="wandb")
    with pytest.raises(ValueError, match="offload_cache='xla'"):
        _toy_trainer("unused", offload_cache="xla")
    trainer = _toy_trainer("out", report_to="tensorboard")
    assert isinstance(trainer.callbacks[-1], TensorBoardCallback)
    assert trainer.callbacks[-1].logdir == "out/tb"


def test_profiler_window_never_opened_warns_and_budget_stops(tmp_path, caplog):
    prof = ProfilerCallback(str(tmp_path / "profile"), start=5, count=1)
    budget = TimeBudgetCallback(budget_seconds=0.0, margin_seconds=0.0)
    trainer = _toy_trainer(tmp_path, callbacks=[prof, budget], save_steps=1)
    with caplog.at_level("WARNING"):
        trainer.train()
    assert "window never opened" in caplog.text
    assert not (tmp_path / "profile").exists()
    assert trainer.stopped_early and trainer.global_step == 1
    assert (tmp_path / "checkpoint-1").is_dir()


# ---------------------------------------------------------------------------
# python -m tpdm_tpu_torch.train.main on the CPU
# ---------------------------------------------------------------------------

def toy_agent_with_decode(config, device="cuda", seed=0):
    """An agent builder for the test's YAML: the toy agent with a toy VAE
    decode for the eval's images."""
    agent = build_toy_agent(config, seed=seed, device=device)
    with torch.device(device):
        vae = VAE(VAEConfig.toy(latent_channels=agent.mmdit.config.in_channels))
    vae.init_weights(torch.Generator(device=device).manual_seed(seed + 1)).eval()
    agent.decode_fn = functools.partial(decode_latents, vae)
    return agent


def _flags(out, episodes, *extra):
    return ["--cpu", "--model_config", str(out.parent / "agent.yaml"),
            "--reward_model_config", f"{TOY}/models/toy_reward.yaml",
            "--train_dataset", f"{TOY}/datasets/jsonl_prompts.yaml",
            "--total_episodes", str(episodes), "--per_device_train_batch_size", "4",
            "--rloo_k", "2", "--max_inference_steps", "3", "--save_steps", "1",
            "--output_dir", str(out), *extra]


def test_main_trains_evaluates_profiles_and_resumes(tmp_path, monkeypatch):
    """Three updates with the eval at update 2, TensorBoard and a profiled
    update 2 (the default collator embeds the prompts), then update 4
    resumed from checkpoint-3."""
    monkeypatch.chdir(REPO)  # the dataset YAML names example/prompts.jsonl
    (tmp_path / "agent.yaml").write_text(
        "_target_: test_torch_train_cli.toy_agent_with_decode\n_partial_: true\nseed: 2\n")
    out = tmp_path / "run"
    trainer = cli.main(_flags(out, 12, "--eval_steps", "2", "--report_to", "tensorboard",
                              "--profile_updates", "1"))
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["update"] for r in rows] == [1, 2, 3] and trainer.global_step == 3
    (event_file,) = (out / "tb").glob("events.out.tfevents.*")
    events = tb.read_scalar_events(str(event_file))
    assert [s for s, _ in events] == [1, 2, 3]
    for (_, scalars), row in zip(events, rows):
        assert scalars == {k: float(np.float32(v)) for k, v in row.items() if k != "update"}
    (ev,) = [cb for cb in trainer.callbacks if isinstance(cb, EvalVisualizationCallback)]
    assert [r["update"] for r in ev.history] == [2]
    rec = ev.history[0]
    assert rec["sigmas"].shape[0] == 10 and ((1 <= rec["nfe"]) & (rec["nfe"] <= 40)).all()
    assert np.isfinite(rec["rewards"]).all() and rec["rewards"].shape == (10,)
    strip = np.asarray(Image.open(out / "eval" / "eval_images_2.png"))
    assert strip.shape == (16, 160, 3) and strip.dtype == np.uint8 and strip.std() > 0
    (prof,) = [cb for cb in trainer.callbacks if isinstance(cb, ProfilerCallback)]
    assert prof.trace_path.endswith("trace_updates_2-2.pt.trace.json")
    names = {e.get("name") for e in json.loads(Path(prof.trace_path).read_text())["traceEvents"]}
    assert "aten::linear" in names
    assert sorted(p.name for p in out.glob("checkpoint-*")) == [
        "checkpoint-1", "checkpoint-2", "checkpoint-3"]

    trainer = cli.main(_flags(out, 16, "--resume_from_checkpoint", "true"))
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["update"] for r in rows] == [1, 2, 3, 4] and trainer.updates_this_run == 1
    assert (out / "checkpoint-4").is_dir()


def test_main_without_cpu_and_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(REPO)
    flags = [f for f in _flags(tmp_path / "run", 8) if f != "--cpu"]
    flags[flags.index("--model_config") + 1] = f"{TOY}/models/toy_agent.yaml"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(flags)
    assert not (tmp_path / "run").exists()
