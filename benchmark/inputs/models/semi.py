"""Semi-continuous (`model_type` "semi"): one codebook of
`model.n_density` codewords shared by every senone, over streams whose
widths `model.featlen` gives (uniform `model.n_feat` x `model.dim` where
it is absent), as pocketsphinx's Sphinx-II models (src/s2_semi_mgau.c;
s2_4x: 12, 24, 3 and 12).  Seeded in the manner of the PTM model
(`synth.make_weights`): Gaussians, mixture weights with a few likely
codewords per senone and stream, and `synth.make_tmat`'s transitions of
`model.n_state` states, over the same text mdef."""

import numpy as np

from benchmark.inputs import synth


def make_weights(mdef_text: str, seed: int, model: dict, feat: str
                 ) -> synth.SynthModel:
    """The seeded arrays over the text mdef, and the `feat.params` of
    the feature type `feat`."""
    rng = np.random.default_rng(seed)
    featlen = list(model.get("featlen") or [model["dim"]] * model["n_feat"])
    F, L, D = len(featlen), max(featlen), model["n_density"]
    S, N = model["n_sen"], model["n_state"]
    n_ci = len(synth.PHONES) + 1 + len(synth.FILLERS)
    lanes = np.arange(L) < np.array(featlen)[:, None, None]   # [F, 1, L]
    means = np.where(lanes, rng.standard_normal((1, F, D, L),
                                                dtype=np.float32), 0)
    var = np.where(lanes, rng.uniform(0.3, 2.0, (1, F, D, L)), 0)
    mixw = rng.integers(60, 160, (F, D, S)).astype(np.uint8)
    hot = rng.integers(0, D, (F, 8, S))
    np.put_along_axis(mixw, hot, rng.integers(0, 30, hot.shape)
                      .astype(np.uint8), axis=1)
    return synth.SynthModel(
        mdef_text=mdef_text, means=means.astype(np.float32),
        var=var.astype(np.float32), mixw=mixw,
        tmat=synth.make_tmat(rng, n_ci, N), featlen=featlen,
        feat_params=synth.feat_params(feat, "semi"))

