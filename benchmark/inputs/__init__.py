"""The benchmark's inputs, made from the seed: frozen copies of the
port's synthetic-model and PCM generators (`synth`)."""
