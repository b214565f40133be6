"""The paper's example applications on the port, as entry points.

Each module is the JAX package's ``examples/<name>.py`` run on PyTorch,
with the same arguments, the same synthetic data (the same numpy seeds,
drawn in the same order) and the same asserts, plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions)::

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.cp_als [--steps 40] [--rank 16]
        [--autotune] [--cache-dir DIR] [--device cpu]
    python -m repro_torch.examples.tucker_hooi [--steps 8] [--autotune]
        [--cache-dir DIR] [--device cpu]
    python -m repro_torch.examples.tensor_completion [--steps 300]
        [--device cpu]
    python -m repro_torch.examples.serve_lm [--device cpu]
    python -m repro_torch.examples.train_lm [--steps 200] [--ckpt-dir DIR]
        [--device cpu]

They import through the ``repro_torch`` facade only, as the reference's
examples import through ``repro``'s (the LM drivers import the model
stack, the ``Server`` and the trainer, which the facade does not cover,
as the reference's do).  Each splits into a function over a given
tensor or model (:func:`cp_als.cp_als`, :func:`tucker_hooi.hooi`,
:func:`tensor_completion.complete`, :func:`serve_lm.serve`,
:func:`train_lm.train`) and a ``main`` that builds the reference's data.
"""
