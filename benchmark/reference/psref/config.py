"""Typed configuration system — the 109-parameter namespace of the reference.

A copy of `pocketsphinx_tpu.config` (NumPy-free host code).

Re-implements the behavior of src/ps_config.c + src/config_macro.h +
src/fe/fe.h's parameter blocks: typed defaults, "-key value" command-line
parsing, lenient JSON in/out (ps_config_parse_json accepts "degenerate
YAML"), model-directory expansion (feat.params merging, default file
names), and the one-search-mode-only validation.

Parameter names, types, defaults and documentation strings are the public
API contract (transcribed from src/config_macro.h and src/fe/fe.h:102-219).
"""

from __future__ import annotations

import json
import os
import re

# name: (type, default, doc)
PARAMS: dict[str, tuple] = {
    "logfn": (str, None, "File to write log messages in"),
    "loglevel": (str, 'WARN', "Minimum level of log messages (DEBUG, INFO, WARN, ERROR)"),
    "mfclogdir": (str, None, "Directory to log feature files to"),
    "rawlogdir": (str, None, "Directory to log raw audio files to"),
    "senlogdir": (str, None, "Directory to log senone score files to"),
    "beam": (float, 1e-48, "Beam width applied to every frame in Viterbi search (smaller values mean wider beam)"),
    "wbeam": (float, 7e-29, "Beam width applied to word exits"),
    "pbeam": (float, 1e-48, "Beam width applied to phone transitions"),
    "lpbeam": (float, 1e-40, "Beam width applied to last phone in words"),
    "lponlybeam": (float, 7e-29, "Beam width applied to last phone in single-phone words"),
    "fwdflatbeam": (float, 1e-64, "Beam width applied to every frame in second-pass flat search"),
    "fwdflatwbeam": (float, 7e-29, "Beam width applied to word exits in second-pass flat search"),
    "pl_window": (int, 5, "Phoneme lookahead window size, in frames"),
    "pl_beam": (float, 1e-10, "Beam width applied to phone loop search for lookahead"),
    "pl_pbeam": (float, 1e-10, "Beam width applied to phone loop transitions for lookahead"),
    "pl_pip": (float, 1.0, "Phone insertion penalty for phone loop"),
    "pl_weight": (float, 3.0, "Weight for phoneme lookahead penalties"),
    "compallsen": (bool, False, "Compute all senone scores in every frame (can be faster when there are many senones)"),
    "fwdtree": (bool, True, "Run forward lexicon-tree search (1st pass)"),
    "fwdflat": (bool, True, "Run forward flat-lexicon search over word lattice (2nd pass)"),
    "bestpath": (bool, True, "Run bestpath (Dijkstra) search over word lattice (3rd pass)"),
    "backtrace": (bool, False, "Print results and backtraces to log."),
    "latsize": (int, 5000, "Initial backpointer table size"),
    "maxwpf": (int, -1, "Maximum number of distinct word exits at each frame (or -1 for no pruning)"),
    "maxhmmpf": (int, 30000, "Maximum number of active HMMs to maintain at each frame (or -1 for no pruning)"),
    "min_endfr": (int, 0, "Nodes ignored in lattice construction if they persist for fewer than N frames"),
    "fwdflatefwid": (int, 4, "Minimum number of end frames for a word to be searched in fwdflat search"),
    "fwdflatsfwin": (int, 25, "Window of frames in lattice to search for successor words in fwdflat search"),
    "keyphrase": (str, None, "Keyphrase to spot"),
    "kws": (str, None, "A file with keyphrases to spot, one per line"),
    "kws_plp": (float, 1e-1, "Phone loop probability for keyphrase spotting"),
    "kws_delay": (int, 10, "Delay to wait for best detection score"),
    "kws_threshold": (float, 1e-30, "Threshold for p(hyp)/p(alternatives) ratio"),
    "fsg": (str, None, "Sphinx format finite state grammar file"),
    "jsgf": (str, None, "JSGF grammar file"),
    "toprule": (str, None, "Start rule for JSGF (first public rule is default)"),
    "fsgusealtpron": (bool, True, "Add alternate pronunciations to FSG"),
    "fsgusefiller": (bool, True, "Insert filler words at each state."),
    "allphone": (str, None, "Perform phoneme decoding with phonetic lm (given here)"),
    "allphone_ci": (bool, True, "Perform phoneme decoding with phonetic lm and context-independent units only"),
    "lm": (str, None, "Word trigram language model input file"),
    "lmctl": (str, None, "Specify a set of language model"),
    "lmname": (str, None, "Which language model in -lmctl to use by default"),
    "lw": (float, 6.5, "Language model probability weight"),
    "fwdflatlw": (float, 8.5, "Language model probability weight for flat lexicon (2nd pass) decoding"),
    "bestpathlw": (float, 9.5, "Language model probability weight for bestpath search"),
    "ascale": (float, 20.0, "Inverse of acoustic model scale for confidence score calculation"),
    "wip": (float, 0.65, "Word insertion penalty"),
    "nwpen": (float, 1.0, "New word transition penalty"),
    "pip": (float, 1.0, "Phone insertion penalty"),
    "uw": (float, 1.0, "Unigram weight"),
    "silprob": (float, 0.005, "Silence word transition probability"),
    "fillprob": (float, 1e-8, "Filler word transition probability"),
    "dict": (str, None, "Main pronunciation dictionary (lexicon) input file"),
    "fdict": (str, None, "Noise word pronunciation dictionary input file"),
    "dictcase": (bool, False, "Dictionary is case sensitive (NOTE: case insensitivity applies to ASCII characters only)"),
    "hmm": (str, None, "Directory containing acoustic model files."),
    "featparams": (str, None, "File containing feature extraction parameters."),
    "mdef": (str, None, "Model definition input file"),
    "senmgau": (str, None, "Senone to codebook mapping input file (usually not needed)"),
    "tmat": (str, None, "HMM state transition matrix input file"),
    "tmatfloor": (float, 0.0001, "HMM state transition probability floor (applied to -tmat file)"),
    "mean": (str, None, "Mixture gaussian means input file"),
    "var": (str, None, "Mixture gaussian variances input file"),
    "varfloor": (float, 0.0001, "Mixture gaussian variance floor (applied to data from -var file)"),
    "mixw": (str, None, "Senone mixture weights input file (uncompressed)"),
    "mixwfloor": (float, 0.0000001, "Senone mixture weights floor (applied to data from -mixw file)"),
    "aw": (int, 1, "Inverse weight applied to acoustic scores."),
    "sendump": (str, None, "Senone dump (compressed mixture weights) input file"),
    "mllr": (str, None, "MLLR transformation to apply to means and variances"),
    "mmap": (bool, True, "Use memory-mapped I/O (if possible) for model files"),
    "ds": (int, 1, "Frame GMM computation downsampling ratio"),
    "topn": (int, 4, "Maximum number of top Gaussians to use in scoring."),
    "topn_beam": (str, '0', "Beam width used to determine top-N Gaussians (or a list, per-feature)"),
    "logbase": (float, 1.0001, "Base in which all log-likelihoods calculated"),
    "logspec": (bool, False, "Write out logspectral files instead of cepstra"),
    "smoothspec": (bool, False, "Write out cepstral-smoothed logspectral files"),
    "transform": (str, 'legacy', "Which type of transform to use to calculate cepstra (legacy, dct, or htk)"),
    "alpha": (float, 0.97, "Preemphasis parameter"),
    "samprate": (int, 16000, "Sampling rate"),
    "frate": (int, 100, "Frame rate"),
    "wlen": (float, 0.025625, "Hamming window length"),
    "nfft": (int, 0, "Size of FFT, or 0 to set automatically (recommended)"),
    "nfilt": (int, 40, "Number of filter banks"),
    "lowerf": (float, 133.33334, "Lower edge of filters"),
    "upperf": (float, 6855.4976, "Upper edge of filters"),
    "unit_area": (bool, True, "Normalize mel filters to unit area"),
    "round_filters": (bool, True, "Round mel filter frequencies to DFT points"),
    "ncep": (int, 13, "Number of cep coefficients"),
    "doublebw": (bool, False, "Use double bandwidth filters (same center freq)"),
    "lifter": (int, 0, "Length of sin-curve for liftering, or 0 for no liftering."),
    "input_endian": (str, 'little', "Endianness of input data, big or little, ignored if NIST or MS Wav"),
    "warp_type": (str, 'inverse_linear', "Warping function type (or shape)"),
    "warp_params": (str, None, "Parameters defining the warping function"),
    "dither": (bool, False, "Add 1/2-bit noise"),
    "seed": (int, -1, "Seed for random number generator; if less than zero, pick our own"),
    "remove_dc": (bool, False, "Remove DC offset from each frame"),
    "remove_noise": (bool, False, "Remove noise using spectral subtraction"),
    "verbose": (bool, False, "Show input filenames"),
    "feat": (str, '1s_c_d_dd', "Feature stream type, depends on the acoustic model"),
    "ceplen": (int, 13, "Number of components in the input feature vector"),
    "cmn": (str, 'live', "Cepstral mean normalization scheme ('live', 'batch', or 'none')"),
    "cmninit": (str, '40,3,-1', "Initial values (comma-separated) for cepstral mean when 'live' is used"),
    "varnorm": (bool, False, "Variance normalize each utterance (only if CMN == current)"),
    "agc": (str, 'none', "Automatic gain control for c0 ('max', 'emax', 'noise', or 'none')"),
    "agcthresh": (float, 2.0, "Initial threshold for automatic gain control"),
    "lda": (str, None, "File containing transformation matrix to be applied to features (single-stream features only)"),
    "ldadim": (int, 0, "Dimensionality of output of feature transformation (0 to use entire matrix)"),
    "svspec": (str, None, "Subvector specification (e.g., 24,0-11/25,12-23/26-38 or 0-12/13-25/26-38)"),
    # CLI-only options (programs/pocketsphinx_main.c)
    "phone_align": (bool, False, "Report phone alignments in results"),
    "state_align": (bool, False, "Report state alignments in results"),
    "config_file": (str, None, "File containing JSON configuration"),
}

_BOOL_TRUE = {"yes", "true", "t", "1", "y", "on"}
_BOOL_FALSE = {"no", "false", "f", "0", "n", "off"}

# feat.params / acoustic-model files merged into the config when -hmm is
# given (ps_expand_model_config, src/pocketsphinx.c:105-158).
_MODEL_FILES = {
    "mdef": "mdef", "mean": "means", "var": "variances",
    "tmat": "transition_matrices", "sendump": "sendump", "mixw": "mixture_weights",
    "fdict": "noisedict", "senmgau": "senmgau", "lda": "feature_transform",
    "featparams": "feat.params",
}


def _coerce(name: str, value):
    if name not in PARAMS:
        raise KeyError(f"Unknown configuration parameter {name!r}")
    typ = PARAMS[name][0]
    if value is None:
        return None
    if typ is bool:
        if isinstance(value, str):
            v = value.strip().lower()
            if v in _BOOL_TRUE:
                return True
            if v in _BOOL_FALSE:
                return False
            raise ValueError(f"Bad boolean value {value!r} for -{name}")
        return bool(value)
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return str(value)


class Config:
    """Typed key/value configuration, dict-like.

    Accepts keys with or without a leading dash ("-beam" == "beam").
    """

    def __init__(self, *args, **kwargs):
        self._values = {k: v[1] for k, v in PARAMS.items()}
        self._user_set = set()
        if args:
            if len(args) == 1 and isinstance(args[0], str):
                self.update(parse_json(args[0]))
            else:
                self.parse_argv(list(args))
        self.update(kwargs)

    @staticmethod
    def _norm(key: str) -> str:
        key = key.lstrip("-_") if key.startswith(("-", "_")) else key
        return key

    def __getitem__(self, key):
        return self._values[self._norm(key)]

    def __setitem__(self, key, value):
        key = self._norm(key)
        self._values[key] = _coerce(key, value)
        self._user_set.add(key)

    def __contains__(self, key):
        return self._norm(key) in self._values

    def get(self, key, default=None):
        k = self._norm(key)
        return self._values.get(k, default)

    def is_user_set(self, key) -> bool:
        return self._norm(key) in self._user_set

    def set_default(self, key, value):
        """Set only if the user has not overridden it."""
        key = self._norm(key)
        if key not in self._user_set:
            self._values[key] = _coerce(key, value)

    def update(self, other):
        for k, v in (other.items() if isinstance(other, dict) else other):
            self[k] = v

    def items(self):
        return self._values.items()

    def describe(self):
        """Yield (name, type, default, doc, current) tuples."""
        for name, (typ, default, doc) in PARAMS.items():
            yield name, typ, default, doc, self._values[name]

    # -- command line --------------------------------------------------------

    def parse_argv(self, argv: list[str]):
        i = 0
        while i < len(argv):
            a = argv[i]
            if not a.startswith("-"):
                raise ValueError(f"Expected option, got {a!r}")
            key = self._norm(a)
            if key not in PARAMS:
                raise KeyError(f"Unknown option {a!r}")
            if i + 1 >= len(argv):
                raise ValueError(f"Missing value for {a!r}")
            self[key] = argv[i + 1]
            i += 2

    # -- JSON ----------------------------------------------------------------

    def serialize_json(self) -> str:
        out = {}
        for k, v in self._values.items():
            if v is None:
                continue
            out[k] = v
        return json.dumps(out, indent=2)

    # -- model expansion -----------------------------------------------------

    def expand_model_config(self):
        """ps_expand_model_config: fill model file paths from the -hmm dir
        and merge feat.params (which overrides defaults but not user
        settings)."""
        hmm = self["hmm"]
        if hmm:
            for key, fname in _MODEL_FILES.items():
                path = os.path.join(hmm, fname)
                if not self.is_user_set(key) and os.path.isfile(path):
                    self._values[key] = path
            fp = self["featparams"]
            if fp and os.path.isfile(fp):
                for k, v in parse_args_file(fp):
                    if k not in PARAMS:
                        continue  # tolerate extra feat.params keys (-model)
                    self.set_default(k, v)
        # sendump takes precedence over mixw like the reference scorers
        return self

    def default_search_args(self):
        """ps_default_search_args: default model from POCKETSPHINX_PATH."""
        root = os.environ.get("POCKETSPHINX_PATH")
        if root is None:
            return self
        en = os.path.join(root, "en-us")
        if not self["hmm"] and os.path.isdir(os.path.join(en, "en-us")):
            self.set_default("hmm", os.path.join(en, "en-us"))
        if not self["lm"] and os.path.isfile(os.path.join(en, "en-us.lm.bin")):
            self.set_default("lm", os.path.join(en, "en-us.lm.bin"))
        if not self["dict"] and os.path.isfile(
                os.path.join(en, "cmudict-en-us.dict")):
            self.set_default("dict", os.path.join(en, "cmudict-en-us.dict"))
        return self

    def validate_search_mode(self) -> str | None:
        """Exactly one of the search-defining options may be set
        (ps_config_validate); returns the active mode name or None."""
        modes = [k for k in ("keyphrase", "kws", "fsg", "jsgf", "allphone",
                             "lm", "lmctl") if self[k]]
        if len(modes) > 1:
            raise ValueError(
                f"Only one of -lm, -lmctl, -fsg, -jsgf, -keyphrase, -kws, "
                f"-allphone may be given; got {modes}")
        return modes[0] if modes else None


def parse_args_file(path: str) -> list[tuple[str, str]]:
    """Parse a feat.params-style '-key value' file."""
    toks = re.split(r"\s+", open(path).read().strip())
    out = []
    i = 0
    while i + 1 < len(toks) or (i < len(toks) and not toks[i].startswith("-")):
        if toks[i].startswith("-"):
            out.append((toks[i].lstrip("-"), toks[i + 1]))
            i += 2
        else:
            i += 1
    return out


def parse_json(text: str) -> dict:
    """Lenient JSON/'degenerate YAML' parser (ps_config_parse_json accepts
    missing braces, 'key: value' lines, and bare words)."""
    text = text.strip()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    body = text
    if body.startswith("{"):
        body = body[1:]
    if body.endswith("}"):
        body = body[:-1]
    out = {}
    # split on commas and newlines
    for item in re.split(r"[,\n]+", body):
        item = item.strip()
        if not item:
            continue
        m = re.match(r'^"?([^":]+)"?\s*:\s*"?([^"]*)"?$', item)
        if not m:
            raise ValueError(f"Cannot parse config item {item!r}")
        out[m.group(1).strip()] = m.group(2).strip()
    return out
