"""Phonetically tied mixtures (`model_type` "ptm"): one codebook per CI
phone, shared by the phone's senones, over streams of one width
(`model.n_feat` x `model.dim`), as pocketsphinx's en-us model
(src/ptm_mgau.c).  The weights are `synth.make_weights`'s."""

from benchmark.inputs import synth


def make_weights(mdef_text: str, seed: int, model: dict, feat: str
                 ) -> synth.SynthModel:
    """The seeded arrays over the text mdef, and the `feat.params` of
    the feature type `feat`."""
    spec = synth.make_weights(mdef_text, seed=seed, n_sen=model["n_sen"],
                              n_density=model["n_density"],
                              n_feat=model["n_feat"], dim=model["dim"],
                              n_state=model["n_state"])
    spec.feat_params = synth.feat_params(feat, "ptm")
    return spec
