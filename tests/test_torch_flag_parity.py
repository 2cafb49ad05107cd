"""Every ported CLI accepts the JAX CLI's flags, with the JAX defaults.

Both packages' parsers are captured by intercepting ``parse_args``, as
tests/test_flag_parity.py does for the reference scripts. The port may add
flags; of the JAX flags, each must exist in the port with an equal default,
except ``--device`` (None in JAX, which ignores it; ``cuda`` in the port,
which places the run with it). The compat flag ``--ckpt`` resolves as the
JAX package's ``apply_compat_flags`` resolves it.
"""

import argparse
import importlib
import re

import pytest

from nextgen_uia_tpu_torch.tasks.common import apply_compat_flags, base_parser

# (module under tasks/, argv that reaches the parser)
CLIS = [("biomedclip.classification", []), ("biomedclip.segmentation", []),
        ("biomedclip.finetune", []), ("biomedclip.predict", []),
        ("biomedclip.predict", ["--task", "seg"]), ("biomedclip.zero_shot", []),
        ("biomedclip.retrieval", []), ("biomedclip.fewshot_classification", []),
        ("biomedclip.fewshot_segmentation", []),
        ("clip.classification", []), ("clip.segmentation", []), ("clip.predict", []),
        ("clip.predict", ["--task", "cls"]), ("clip.zero_shot", []), ("clip.finetune", []),
        ("metaclip.classification", []), ("metaclip.segmentation", []),
        ("metaclip.predict", []), ("metaclip.zero_shot", []), ("metaclip.finetune", []),
        ("unimedclip.classification", []), ("unimedclip.segmentation", []),
        ("unimedclip.predict", []), ("unimedclip.zero_shot", []),
        ("unimedclip.finetune", []),
        ("dino.classification", []), ("dino.segmentation", []), ("dino.predict", []),
        ("clipseg.segmentation", []), ("clipseg.predict", []),
        ("baselines.classification", []), ("baselines.segmentation", []),
        ("baselines.fewshot_classification", []), ("baselines.fewshot_segmentation", []),
        ("baselines.predict", []), ("baselines.predict", ["--task", "seg"])]
DIFFERENT_DEFAULT = {"device"}


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser(package, cli, argv, monkeypatch):
    mod = importlib.import_module(f"{package}.tasks.{cli}")

    def grab(self, *a, **kw):
        raise _Captured(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        try:
            mod.main(list(argv))
        except _Captured as c:
            return {a.dest: a.default for a in c.parser._actions if a.option_strings
                    and a.dest != "help"}
    raise AssertionError(f"{package}.tasks.{cli} never parsed its arguments")


@pytest.mark.parametrize("cli,argv", CLIS, ids=[" ".join([c, *a]) for c, a in CLIS])
def test_port_accepts_the_jax_flags(cli, argv, monkeypatch):
    jax_flags = _parser("nextgen_uia_tpu", cli, argv, monkeypatch)
    port_flags = _parser("nextgen_uia_tpu_torch", cli, argv, monkeypatch)
    missing = sorted(set(jax_flags) - set(port_flags))
    assert not missing, f"{cli}: the port does not accept {missing}"
    differ = {k: (v, port_flags[k]) for k, v in jax_flags.items()
              if k not in DIFFERENT_DEFAULT and port_flags[k] != v}
    assert not differ, f"{cli}: defaults differ (JAX, port): {differ}"
    assert (jax_flags["device"], port_flags["device"]) == (None, "cuda")


def test_compat_flags_parse():
    args = base_parser("t").parse_args(["--ckpt", "w.npz", "--version", "ViT-B/16",
                                        "--in_channels", "1"])
    assert (args.ckpt, args.version, args.in_channels) == ("w.npz", "ViT-B/16", 1)
    defaults = base_parser("t").parse_args([])
    assert (defaults.ckpt, defaults.version, defaults.in_channels) == (None, None, 3)


def test_ckpt_npz_becomes_backbone_ckpt(tmp_path):
    args = base_parser("t").parse_args(["--ckpt", "runs/x.npz"])
    apply_compat_flags(args)
    assert args.backbone_ckpt == "runs/x.npz"
    kept = base_parser("t").parse_args(["--ckpt", "runs/x.npz", "--backbone_ckpt", "b.npz"])
    apply_compat_flags(kept)
    assert kept.backbone_ckpt == "b.npz"
    # a reference-style default path that does not exist stays informational
    absent = base_parser("t").parse_args(["--ckpt", str(tmp_path / "ViT-B-16.pt")])
    apply_compat_flags(absent)
    assert absent.backbone_ckpt is None


def test_ckpt_torch_archive_names_the_converter_item(tmp_path):
    """A torch archive through --ckpt refuses, as the JAX package's does,
    naming the port's own converter (never the JAX package's)."""
    archive = tmp_path / "ViT-B-16.pt"
    archive.write_bytes(b"not an npz")
    args = base_parser("t").parse_args(["--ckpt", str(archive)])
    want = f"python -m nextgen_uia_tpu_torch.convert <kind> {archive} out.npz"
    with pytest.raises(SystemExit, match=re.escape(want)) as err:
        apply_compat_flags(args)
    assert "nextgen_uia_tpu.convert" not in str(err.value)
