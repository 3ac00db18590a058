"""Pure-JAX loader for the reference's manifold VAE models.

The reference's voice-conversion path (encode_vae, main.py:367-384) depends
on external Keras models (/root/reference/manifold/timit_vae_{encoder,
decoder}_0001 — 39-256-256-256-12 relu MLPs).  This module loads those h5
weight files directly (h5py, no TensorFlow) into a jit-compiled MLP with a
Keras-compatible ``.predict`` so the full VC pipeline runs under JAX.
"""
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_ACTIVATIONS = {
    "relu": jax.nn.relu,
    "linear": lambda x: x,
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "softplus": jax.nn.softplus,
    "elu": jax.nn.elu,
}


class MLP:
    """A dense MLP with a Keras-like ``predict`` API, executed under jit."""

    def __init__(self, weights, activations):
        self.weights = [(jnp.asarray(w), jnp.asarray(b)) for w, b in weights]
        self.activations = list(activations)
        acts = tuple(self.activations)

        @jax.jit
        def forward(params, x):
            for (w, b), act in zip(params, acts):
                x = _ACTIVATIONS[act](jnp.dot(
                    x, w, precision=jax.lax.Precision.HIGHEST) + b)
            return x

        self._forward = forward

    def predict(self, X, batch_size=None):
        del batch_size  # the whole batch runs as one jitted call
        return np.asarray(self._forward(self.weights, jnp.asarray(X)))

    @classmethod
    def from_keras_h5(cls, path):
        """Load a sequential Dense Keras model saved in h5 format."""
        import h5py

        with h5py.File(path, "r") as f:
            cfg = json.loads(f.attrs["model_config"])
            layer_cfgs = cfg["config"]["layers"] if isinstance(
                cfg["config"], dict) else cfg["config"]
            weights, acts = [], []
            mw = f["model_weights"]
            for layer in layer_cfgs:
                if layer["class_name"] != "Dense":
                    continue
                name = layer["config"]["name"]
                g = mw[name][name]
                weights.append((np.asarray(g["kernel:0"]),
                                np.asarray(g["bias:0"])))
                acts.append(layer["config"]["activation"])
        return cls(weights, acts)


def load_manifold_vae(encoder_path, decoder_path):
    """(encoder, decoder) MLPs compatible with World.encode_vae."""
    return MLP.from_keras_h5(encoder_path), MLP.from_keras_h5(decoder_path)
