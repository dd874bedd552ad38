"""The JAX package's command lines on the port's CLIs, its ``tb_export``,
and the port's launchers, on the CPU.

* Every option string of the JAX parsers of ``tools/test.py``,
  ``tools/train.py``, ``tools/export.py`` and ``tools/convert.py`` parses
  in the port's counterpart, with a value where it takes one, to the value
  the JAX parser gives (the JAX parsers are read by running their
  ``parse_args`` under a patched ``sys.argv``, never their ``main``).
  A ``--platforms`` other than one of cpu, cuda and gpu is refused with a
  message.
* The test CLI gives the same result dict with ``--eval mIoU --pad-bucket 1
  --postproc-workers 2`` as without them (a small FPN on
  ``tests/data/ade20k_tiny``, ``--device cpu``), and with ``--no-exact
  --pad-bucket 32`` the JAX CLI's result dict for the same command line.
* The port's ``tools/tb_export.py`` writes the JAX tool's event records on
  one JSONL, byte for byte but for the wall times.
* ``tools/launch_multihost.sh`` and ``tools/launch_slurm.sh`` build their
  torchrun command lines: fake ``srun``, ``scontrol``, ``nvidia-smi`` and
  ``python3`` that echo their arguments are put first on ``PATH``.
"""

import argparse
import dataclasses
import functools
import importlib
import importlib.util
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dat_segmentation_tpu_torch import build_model, get_config
from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
from dat_segmentation_tpu_torch.tools import convert as convert_cli
from dat_segmentation_tpu_torch.tools import export as export_cli
from dat_segmentation_tpu_torch.tools import tb_export
from dat_segmentation_tpu_torch.tools import test as test_cli
from dat_segmentation_tpu_torch.tools import train as train_cli
from dat_segmentation_tpu_torch.eval.inference import SegInferencer
from dat_segmentation_tpu_torch.tools.reference_schema import save_reference, to_reference
from dat_segmentation_tpu_torch.utils.tensorboard import _masked_crc
from torch_port_helpers import ShapeInit, jax_reference_keys, small_fpn

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data" / "ade20k_tiny"
TOOLS = ROOT / "dat_segmentation_tpu_torch" / "tools"

PORT = {"test": test_cli, "train": train_cli, "export": export_cli, "convert": convert_cli}
# each CLI's positional and required arguments
BASE = {"test": ["fpn_tiny_80k_dp04_lr2", "ckpt.pth", "--data-root", "data"],
        "train": ["fpn_tiny_80k_dp04_lr2", "--data-root", "data"],
        "export": ["fpn_tiny_80k_dp04_lr2", "random", "--output", "art"],
        "convert": ["fpn_tiny_80k_dp04_lr2", "x.pth", "out"]}
REFUSED = set()  # (tool, option) pairs the port refuses: none since --no-exact runs
MAX_FLIPPED = 1e-4  # share of the pixels whose class may flip at a near-tie, as test_torch_evaluate
VALUES = {"--platforms": "cpu", "--shard": "0/2", "--shapes": "64x64,64x96"}


def _jax_module(tool):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{tool}", ROOT / "tools" / f"{tool}.py")
    module = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(module)  # argparse only: each main imports JAX itself
    finally:
        sys.path[:] = path  # the JAX tools put the repository first on sys.path
    return module


def _jax_parse(tool, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{tool}.py", *argv])
    return _jax_module(tool).parse_args()


def _jax_options(tool):
    """The optional actions of the JAX CLI's parser (its ``parse_args``
    stopped before it reads ``sys.argv``)."""
    parser = []

    class Stop(Exception):
        pass

    def grab(self, args=None, namespace=None):
        parser.append(self)
        raise Stop

    module = _jax_module(tool)
    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(Stop):
            module.parse_args()
    finally:
        argparse.ArgumentParser.parse_args = real
    return [a for a in parser[0]._actions
            if a.option_strings and not isinstance(a, argparse._HelpAction)]


def _argv(action, option):
    if action.nargs == 0:
        return [option]
    if option in VALUES:
        return [option, VALUES[option]]
    if action.choices:
        return [option, next(c for c in action.choices if c is not None)]
    if action.nargs == "*":
        return [option, "a=1", "b=2"]
    return [option, "1" if action.type is int else "x"]


CASES = [(tool, option, action) for tool in PORT for action in _jax_options(tool)
         for option in action.option_strings]


def test_the_jax_parsers_have_options():
    assert {tool for tool, _, _ in CASES} == set(PORT)
    assert {"--eval", "--pad-bucket", "--postproc-workers", "--no-exact", "--diff-seed",
            "--platforms"} <= {option for _, option, _ in CASES}


@pytest.mark.parametrize("tool,option,action", CASES,
                         ids=[f"{t}{o}" for t, o, _ in CASES])
def test_every_jax_option_parses_in_the_port(tool, option, action, monkeypatch, capsys):
    argv = BASE[tool] + _argv(action, option)
    want = getattr(_jax_parse(tool, argv, monkeypatch), action.dest)
    if (tool, option) in REFUSED:
        with pytest.raises(SystemExit) as e:
            PORT[tool].parse_args(argv)
        assert e.value.code == 2 and option in capsys.readouterr().err
        return
    assert getattr(PORT[tool].parse_args(argv), action.dest) == want


@pytest.mark.parametrize("argv,message", [
    (["--platforms", "tpu"], "one of cpu, cuda, gpu"),
    (["--platforms", "cpu,tpu"], "one of cpu, cuda, gpu"),
    (["--platforms", "cuda", "--device", "cpu"], "disagree"),
], ids=["tpu", "two_platforms", "platform_and_device"])
def test_what_the_port_cannot_do_is_refused(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        PORT["export"].parse_args(BASE["export"] + argv)
    assert e.value.code == 2 and message in capsys.readouterr().err


def test_no_exact_gives_the_jax_cli_result(tmp_path, monkeypatch):
    """``--no-exact --pad-bucket 32`` (the JAX package's plain zero-pad path,
    bucket-batched at the default batch of 4) on both CLIs: one
    mmseg-schema .pth of a 150-class small FPN, the first three fixture
    images at img_scale (128, 64) (64x64 inputs and a 64x85 one in a 64x96
    bucket), float32 on both sides (each CLI's inferencer told so). The
    result dicts are equal but for pixels whose class flips at a logit
    near-tie: the counts differ by at most one a flipped pixel in ``inter``
    and two in ``union``, and at most 1e-4 of the pixels flip."""
    import jax.numpy as jnp

    import dat_segmentation_tpu.eval as jax_eval
    import dat_segmentation_tpu.models as jax_models
    from dat_segmentation_tpu.configs import get_config as jax_get_config

    def small(get_config):
        cfg = get_config("fpn_tiny_80k_dp04_lr2")
        return dataclasses.replace(cfg, model=small_fpn(get_config, num_classes=150),
                                   data=dataclasses.replace(cfg.data, img_scale=(128, 64)))

    port_cfg = small(get_config)
    torch.manual_seed(7)
    model = build_model(port_cfg.model, device="cpu")
    pth = save_reference(model, port_cfg.model, tmp_path / "m.pth")
    jax_pth = tmp_path / "m_jax.pth"
    torch.save({"state_dict": jax_reference_keys(to_reference(model.state_dict(),
                                                                port_cfg.model))}, jax_pth)
    flags = ["--data-root", str(DATA), "--max-images", "3", "--no-exact", "--pad-bucket", "32"]

    monkeypatch.setattr(test_cli, "load_config", lambda name: port_cfg)
    monkeypatch.setattr(test_cli, "SegInferencer",
                        functools.partial(SegInferencer, compute_dtype=torch.float32))
    calls = []
    monkeypatch.setattr(SegInferencer, "forward_batch", lambda self, x, valid_hw=None, _f=(
        SegInferencer.forward_batch): calls.append((tuple(x.shape), valid_hw)) or _f(self, x, valid_hw))
    got = test_cli.main(["fpn_tiny_80k_dp04_lr2", str(pth), *flags, "--device", "cpu"])
    assert calls == [((4, 64, 64, 3), None), ((4, 64, 96, 3), None)], calls

    monkeypatch.syspath_prepend(str(ROOT))
    jax_test_cli = importlib.import_module("tools.test")
    jax_train_cli = importlib.import_module("tools.train")
    build = jax_models.build_model
    monkeypatch.setattr(jax_models, "build_model", lambda c: ShapeInit(build(c)))
    monkeypatch.setattr(jax_train_cli, "load_config", lambda name: small(jax_get_config))
    monkeypatch.setattr(jax_eval, "SegInferencer", functools.partial(
        jax_eval.SegInferencer, compute_dtype=jnp.float32, transfer_dtype=jnp.float32))
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["tools/test.py", "fpn_tiny_80k_dp04_lr2", str(jax_pth),
                                      *flags, "--out", str(out)])
    jax_test_cli.main()
    ref = json.loads(out.read_text())

    assert set(got) == set(ref) and got["num_images"] == ref["num_images"] == 3
    ds = ADE20KDataset(DATA, "val")
    pixels = sum(ds.load_raw(i)[1].size for i in range(3))
    d_inter = sum(abs(a - b) for a, b in zip(got["inter"], ref["inter"]))
    d_union = sum(abs(a - b) for a, b in zip(got["union"], ref["union"]))
    assert d_inter <= MAX_FLIPPED * pixels and d_union <= 2 * MAX_FLIPPED * pixels, (
        d_inter, d_union, pixels)
    assert got["mIoU"] == pytest.approx(ref["mIoU"], abs=1e-3)


@pytest.mark.parametrize("argv,device", [([], None), (["--platforms", "gpu"], "cuda"),
                                         (["--platforms", "CPU"], "cpu"),
                                         (["--platforms", "cuda", "--device", "cuda:1"], "cuda:1")])
def test_platforms_names_the_device(argv, device):
    assert export_cli.parse_args(BASE["export"] + argv).device == device


def test_diff_seed_is_a_no_op_that_says_why(monkeypatch, capsys):
    from dat_segmentation_tpu_torch.train import trainer_seg

    seen = []
    monkeypatch.setattr(trainer_seg, "train_segmentation", lambda cfg, **k: seen.append(cfg))
    for flag in ([], ["--diff-seed"]):
        train_cli.main(["fpn_tiny_80k_dp04_lr2", "--data-root", "d", "--device", "cpu", *flag])
    assert seen[0] == seen[1]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("--diff-seed: a no-op")


def test_the_test_cli_takes_the_jax_flags_and_gives_the_same_result(tmp_path, monkeypatch):
    cfg = get_config("fpn_tiny_80k_dp04_lr2")
    small = dataclasses.replace(cfg, model=small_fpn(get_config, num_classes=150),
                                data=dataclasses.replace(cfg.data, img_scale=(128, 64)))
    monkeypatch.setattr(test_cli, "load_config", lambda name: small)
    torch.manual_seed(0)
    ckpt = save_reference(build_model(small.model, device="cpu"), small.model,
                          tmp_path / "fpn.pth")
    base = ["fpn_tiny_80k_dp04_lr2", str(ckpt), "--data-root", str(DATA), "--max-images", "2",
            "--device", "cpu"]
    plain = test_cli.main(base)
    jax_line = test_cli.main(base + ["--eval", "mIoU", "--pad-bucket", "1",
                                     "--postproc-workers", "2"])
    assert plain["num_images"] == 2 and json.dumps(jax_line) == json.dumps(plain)


# ---- tb_export --------------------------------------------------------------

def _records(path):
    """The payloads of a TFRecord file, each CRC checked."""
    data, out, off = path.read_bytes(), [], 0
    while off < len(data):
        header = data[off:off + 8]
        (length,) = struct.unpack("<Q", header)
        assert struct.unpack_from("<I", data, off + 8)[0] == _masked_crc(header)
        payload = data[off + 12:off + 12 + length]
        assert struct.unpack_from("<I", data, off + 12 + length)[0] == _masked_crc(payload)
        out.append(payload)
        off += 16 + length
    return out


def _fields(buf):
    """(field number, value) of a protobuf message: varints, 64-bit,
    length-delimited and 32-bit fields (the Event's and Summary's)."""
    off = 0
    while off < len(buf):
        key, off = _varint(buf, off)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _varint(buf, off)
        elif wire == 1:
            val, off = buf[off:off + 8], off + 8
        elif wire == 2:
            n, off = _varint(buf, off)
            val, off = buf[off:off + n], off + n
        else:
            val, off = buf[off:off + 4], off + 4
        yield num, val


def _varint(buf, off):
    val = shift = 0
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return val, off


def _decoded(payload):
    """(step, file version, [(tag, value)]) of one Event."""
    step, version, scalars = 0, "", []
    for num, val in _fields(payload):
        if num == 2:
            step = val
        elif num == 3:
            version = val.decode()
        elif num == 5:
            for _, value in _fields(val):
                v = dict(_fields(value))
                scalars.append((v[1].decode(), struct.unpack("<f", v[2])[0]))
    return step, version, scalars


def test_tb_export_writes_the_jax_tools_records(tmp_path, monkeypatch):
    import runpy

    src = tmp_path / "train.scalars.jsonl"
    src.write_text("\n".join([
        json.dumps({"step": 50, "time": 1.0, "loss": 2.5, "lr": 6e-5}),
        "",
        json.dumps({"step": 100, "loss": 1.25, "note": "a string", "mIoU": 0.4375}),
        json.dumps({"time": 3.0, "note": "nothing to write"}),
        json.dumps({"step": 200, "decode_head.loss_ce": 0.75, "ok": True}),
    ]) + "\n")
    monkeypatch.setattr(sys, "argv", ["tb_export.py", str(src), "--out", str(tmp_path / "jax")])
    runpy.run_path(str(ROOT / "tools" / "tb_export.py"), run_name="__main__")
    out = tb_export.main([str(src)])
    assert out == tmp_path / "tb"
    (jax_file,) = (tmp_path / "jax").glob("events.out.tfevents.*")
    (port_file,) = out.glob("events.out.tfevents.*")
    jax_events, port_events = _records(jax_file), _records(port_file)
    # each Event starts with its wall time (field 1, 8 bytes): the rest is equal
    assert [e[9:] for e in port_events] == [e[9:] for e in jax_events]
    assert [_decoded(e) for e in port_events] == [
        (0, "brain.Event:2", []),
        (50, "", [("loss", 2.5), ("lr", pytest.approx(6e-5))]),
        (100, "", [("loss", 1.25), ("mIoU", 0.4375)]),
        (200, "", [("decode_head.loss_ce", 0.75), ("ok", 1.0)]),
    ]


# ---- the launchers ------------------------------------------------------------

FAKES = {
    # srun: its arguments, then the task once on each node, with that node's variables
    "srun": 'echo "srun $*"\nwhile [ "$1" != bash ]; do shift; done\n'
            'for i in $(seq 0 $((NNODES - 1))); do\n'
            '  SLURM_NODEID=$i SLURM_JOB_NODELIST="gpu[07-08]" "$@"\ndone\n',
    "scontrol": '[ "$1 $2 $3" = "show hostnames gpu[07-08]" ] && printf "gpu07\\ngpu08\\n"\n',
    "nvidia-smi": '[ "$1" = -L ] && printf "GPU 0: H100\\nGPU 1: H100\\nGPU 2: H100\\n"\n',
    "python3": 'echo "python3 $*"\n',
}


@pytest.fixture
def fake_path(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, body in FAKES.items():
        (bin_dir / name).write_text("#!/bin/bash\n" + body)
        (bin_dir / name).chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if k not in ("NNODES", "GPUS_PER_NODE", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT",
                        "MODE", "CPUS", "SRUN_ARGS")}
    return dict(env, PATH=f"{bin_dir}:{env['PATH']}")


def _run(script, args, env):
    """The fake srun's line (its arguments: the task's script spans lines)
    first, then each fake python3 line."""
    proc = subprocess.run(["bash", str(TOOLS / script), *args], env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    srun, _, rest = proc.stdout.rstrip("\n").partition("\npython3 ")
    if not srun.startswith("srun "):
        return proc.stdout.splitlines()
    return [srun] + ["python3 " + line for line in rest.split("\npython3 ")]


def torchrun(nnodes, nproc, rank, addr, port):
    return (f"python3 -m torch.distributed.run --nnodes {nnodes} --nproc_per_node {nproc} "
            f"--node_rank {rank} --master_addr {addr} --master_port {port} ")


TRAIN = "-m dat_segmentation_tpu_torch.tools.train upn_tiny_160k_dp03_lr6 --data-root /data/ade"


@pytest.mark.parametrize("knobs,head", [
    ({}, torchrun(1, 3, 0, "localhost", 29500)),
    ({"NNODES": "2", "NODE_RANK": "1", "MASTER_ADDR": "node0", "MASTER_PORT": "6000",
      "GPUS_PER_NODE": "8"}, torchrun(2, 8, 1, "node0", 6000)),
], ids=["defaults", "two_nodes"])
def test_launch_multihost_runs_torchrun(fake_path, knobs, head):
    out = _run("launch_multihost.sh", ["upn_tiny_160k_dp03_lr6", "/data/ade", "--set",
                                       "fsdp=True"], dict(fake_path, **knobs))
    assert out == [head + TRAIN + " --multihost --set fsdp=True"]


def test_launch_slurm_runs_one_torchrun_a_node(fake_path):
    out = _run("launch_slurm.sh", ["gpu", "dat_upn", "upn_tiny_160k_dp03_lr6", "/data/ade",
                                   "--work-dir", "w d"],
               dict(fake_path, NNODES="2", SRUN_ARGS="--time=1:00 --exclusive"))
    assert out[0].startswith("srun -p gpu --job-name=dat_upn --nodes=2 --ntasks=2 "
                             "--ntasks-per-node=1 --cpus-per-task=16 --kill-on-bad-exit=1 "
                             "--time=1:00 --exclusive bash -c ")
    assert out[1:] == [torchrun(2, 3, i, "gpu07", 29500) + TRAIN
                       + " --multihost --work-dir w d" for i in (0, 1)]


def test_launch_slurm_test_mode_runs_the_test_cli(fake_path):
    out = _run("launch_slurm.sh", ["gpu", "dat_eval", "upn_tiny_160k_dp03_lr6", "ckpt.pth",
                                   "--data-root", "/data/ade", "--aug-test"],
               dict(fake_path, MODE="test", GPUS_PER_NODE="4", CPUS="8", MASTER_PORT="7000"))
    assert "--nodes=1 --ntasks=1 --ntasks-per-node=1 --cpus-per-task=8 " in out[0]
    assert out[1:] == [torchrun(1, 4, 0, "gpu07", 7000)
                       + "-m dat_segmentation_tpu_torch.tools.test upn_tiny_160k_dp03_lr6 "
                       "ckpt.pth --distributed --data-root /data/ade --aug-test"]
