"""The port stands alone: it imports and runs with JAX blocked, imports
nothing of JAX or of the JAX package, and its entry points run on CUDA
unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "pocketsphinx_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__") for p in PORT.rglob("*.py"))


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "for name in sys.argv[1:]:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "chip_smoke.fan_inputs, chip_smoke.chain_inputs, chip_smoke.main_path\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'pocketsphinx_tpu.'))"
        " or m == 'pocketsphinx_tpu' for m, v in sys.modules.items()"
        " if v is not None)\n")
    r = subprocess.run([sys.executable, "-c", code, *MODULES], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _dynamic_import(node):
    """The name argument of an `importlib.import_module(...)` or
    `__import__(...)` call, else None."""
    if not isinstance(node, ast.Call) or not node.args:
        return None
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
    return node.args[0] if name in ("import_module", "__import__") else None


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            # a relative module lies in the port; `from .. import
            # ps_native` still names the JAX package's C extension
            names = [node.module or ""] if node.level == 0 else []
            names += [a.name for a in node.names]
        elif (arg := _dynamic_import(node)) is not None:
            # a computed module name could be anything: only literals
            assert isinstance(arg, ast.Constant) and isinstance(
                arg.value, str), \
                f"{path.name}:{node.lineno} imports a computed module name"
            names = [arg.value]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "pocketsphinx_tpu"), \
                f"{path.name} imports {n}"
            assert "ps_native" not in n.split("."), \
                f"{path.name} imports the C extension ps_native"


@pytest.mark.parametrize("src", [
    "import importlib\nimportlib.import_module(f'{pkg}.search')",
    "__import__('pocketsphinx_tpu.search.ngram_fused')",
    "from importlib import import_module\nimport_module('jax.numpy')",
    "import jax.numpy",
    "from pocketsphinx_tpu.lm import ngram",
    "from pocketsphinx_tpu import config",
    "import pocketsphinx_tpu.config",
    "from .. import ps_native",
    "from pocketsphinx_tpu.ps_native import lattice_scan",
])
def test_import_scan_catches(src, tmp_path):
    """The scan above rejects static and dynamic imports alike."""
    bad = tmp_path / "bad.py"
    bad.write_text(src)
    with pytest.raises(AssertionError):
        test_no_jax_or_jax_package_imports(bad)


def test_decoder_modules_import_alone():
    """The facade's modules, the grammar, keyword, allphone and align
    searches among them, and `chip_smoke.py`'s phase 8 load with JAX and
    the JAX package blocked, and the package exports the decoder
    lazily."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pocketsphinx_tpu'] = None\n"
        "import pocketsphinx_tpu_torch as p\n"
        "assert 'pocketsphinx_tpu_torch.decoder' not in sys.modules\n"
        "p.Decoder, p.Config, p.Hypothesis, p.Segment, p.err\n"
        "from pocketsphinx_tpu_torch.search.lattice import Lattice\n"
        "from pocketsphinx_tpu_torch.frontend.stream import FeatStream\n"
        "from pocketsphinx_tpu_torch.search import fsg, kws, allphone, align\n"
        "from pocketsphinx_tpu_torch.lm.jsgf import Jsgf, JsgfError\n"
        "from pocketsphinx_tpu_torch.models.chains import append_word_chain\n"
        "import chip_smoke\n"
        "chip_smoke.modes\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_corpus_modules_import_alone():
    """The corpus pipelines, the batch CLI, the sound reader, WER and the
    evaluation corpus, and `chip_smoke.py`'s phase 9 load with JAX and the
    JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pocketsphinx_tpu'] = None\n"
        "from pocketsphinx_tpu_torch.parallel import BatchDecodePipeline, "
        "make_mesh\n"
        "from pocketsphinx_tpu_torch.parallel.batch import init_distributed, "
        "shard_ctl, global_metric_sum\n"
        "from pocketsphinx_tpu_torch.parallel.pipeline import "
        "TwoStagePipeline\n"
        "from pocketsphinx_tpu_torch import cli_batch, wer, evalcorpus\n"
        "from pocketsphinx_tpu_torch.fileio.sound import read_audio\n"
        "from pocketsphinx_tpu_torch.testing.synth import dictionary_for_lm\n"
        "import chip_smoke\n"
        "chip_smoke.reference_scale, chip_smoke.guard_topm, "
        "chip_smoke.batch_cli\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_tp_modules_import_alone():
    """Tensor parallelism (the 2-D mesh, the decoder's split, the split
    tables and scoring) and `chip_smoke.py`'s phase 11 load and run on a
    CPU mesh with JAX and the JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pocketsphinx_tpu'] = None\n"
        "from pocketsphinx_tpu_torch.parallel import make_mesh\n"
        "from pocketsphinx_tpu_torch.convert import column_ranges, "
        "split_scan_tables, split_scoring_tensors\n"
        "from pocketsphinx_tpu_torch.search.ngram_fused import "
        "NgramFusedDecoder\n"
        "from pocketsphinx_tpu_torch.models.acoustic import senone_scores\n"
        "assert make_mesh(2, 2, device='cpu').devices.shape == (2, 2)\n"
        "assert column_ranges(7, 2) == [(0, 4), (4, 7)]\n"
        "NgramFusedDecoder.shard, senone_scores\n"
        "import chip_smoke\n"
        "chip_smoke.tensor_parallel, chip_smoke.tp_20k, chip_smoke.tp_126k, "
        "chip_smoke.tp_cards\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_cli_modules_import_alone():
    """The CLI, the compat API, the VAD, the host tools, the flat search
    and the int-parity scorer, and `chip_smoke.py`'s phase 10, load with
    JAX and the JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pocketsphinx_tpu'] = None\n"
        "from pocketsphinx_tpu_torch import cli, compat, cli_tools\n"
        "from pocketsphinx_tpu_torch.vad import Vad, Endpointer\n"
        "from pocketsphinx_tpu_torch.vad.webrtc import VadCore\n"
        "from pocketsphinx_tpu_torch.lm.arpabo import ArpaBoLM, to_textgrid\n"
        "from pocketsphinx_tpu_torch.lm.ngram import write_arpa, "
        "write_trie_bin, write_dmp\n"
        "from pocketsphinx_tpu_torch.fileio.bin_mdef import write_bin_mdef, "
        "write_text_mdef\n"
        "from pocketsphinx_tpu_torch.fileio.acoustic import read_mixw_float\n"
        "from pocketsphinx_tpu_torch.models.chains import "
        "append_word_chain_mpx\n"
        "from pocketsphinx_tpu_torch.search.ngram_flat import "
        "NgramFlatDecoder\n"
        "from pocketsphinx_tpu_torch.ops.senone_parity import "
        "PTMParityScorer\n"
        "import chip_smoke\n"
        "chip_smoke.cli_20k, chip_smoke.cli_1k7, chip_smoke.flat_1k7, "
        "chip_smoke.flat_20k, chip_smoke.topk_exact\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_corpus_entry_points_default_to_cuda(monkeypatch, capsys):
    """The mesh, and so the corpus pipeline, and the batch CLI run on CUDA
    unless asked for the CPU."""
    from pocketsphinx_tpu_torch import cli_batch
    from pocketsphinx_tpu_torch.parallel import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(n_data=1, n_model=2)
    assert make_mesh(device="cpu").shape == {"data": 1, "model": 1}
    assert make_mesh(n_model=2, device="cpu").shape == {"data": 1,
                                                        "model": 2}
    assert cli_batch.main(["-ctl", "x", "-hmm", "y"]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    from pocketsphinx_tpu_torch import resolve_device
    from pocketsphinx_tpu_torch.frontend.mfcc import MelFrontend
    from pocketsphinx_tpu_torch.testing import synth

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        MelFrontend().process_batch(np.zeros((1, 4000), np.float32))
    dic = str(tmp_path / "small.dic")
    synth.small_dictionary(dic, n_words=5)
    lmf = synth.write_arpa(["a"], str(tmp_path / "lm.arpa"))
    spec = synth.make_model([dic], n_sen=126 + 60, n_density=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        synth.build_decoder(spec, str(tmp_path), dic, lmf)
    # the grammar, keyword, allphone, align and flat searches too
    from pocketsphinx_tpu_torch.fileio.dictionary import Dictionary
    from pocketsphinx_tpu_torch.lm.fsg import FsgModel
    from pocketsphinx_tpu_torch.models.dict2pid import Dict2Pid
    from pocketsphinx_tpu_torch.search.align import Aligner
    from pocketsphinx_tpu_torch.search.allphone import AllphoneDecoder
    from pocketsphinx_tpu_torch.search.fsg import FsgDecoder
    from pocketsphinx_tpu_torch.search.kws import KwsDecoder
    am, noise = spec.load(str(tmp_path / "model"))
    d2p = Dict2Pid(am.mdef, Dictionary(am.mdef, dic, noise))
    word = d2p.dict.wordstr(0)
    fsg = FsgModel("g", 2, 0, 1)
    fsg.trans_add(0, 1, 0.0, fsg.word_add(word))
    from pocketsphinx_tpu_torch.lm.ngram import read_lm
    from pocketsphinx_tpu_torch.search.ngram_flat import NgramFlatDecoder
    for make in (lambda: FsgDecoder(am, d2p, fsg),
                 lambda: KwsDecoder(am, d2p, [(word, 1e-30)]),
                 lambda: AllphoneDecoder(am), lambda: Aligner(am, d2p),
                 lambda: NgramFlatDecoder(am, d2p, read_lm(lmf))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert len(fsg.links) == 1            # refused before editing the grammar
    assert resolve_device("cpu") == torch.device("cpu")


def test_default_card_is_current(monkeypatch):
    """The default device, and "cuda" without an index, is the card
    current when it is resolved."""
    from pocketsphinx_tpu_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve_device() == torch.device("cuda", 1)
    assert resolve_device("cuda") == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_precision_setup():
    import pocketsphinx_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
