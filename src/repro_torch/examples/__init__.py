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

They import through the ``repro_torch`` facade only, as the reference's
examples import through ``repro``'s.  Each splits into a function over a
given tensor (:func:`cp_als.cp_als`, :func:`tucker_hooi.hooi`,
:func:`tensor_completion.complete`) and a ``main`` that builds the
reference's data.
"""
