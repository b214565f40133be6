"""The continuous-batching ``Server`` in the port, held to the reference.

Both packages' servers run from the same params (the reference's
``model_init(PRNGKey(0))`` carried across by ``params_from_jax``) on the
same prompts, and the port's tokens must equal the reference's:

* the cases of ``tests/test_serve.py``: ``max_new=1`` requests finished
  straight out of prefill are not dropped, mixed-length prompts decode at
  their own positions (each equal to its solo run), and a prompt longer
  than ``cache_len`` is refused;
* decoding past ``cache_len`` (``cache_len=8``, a 6-token prompt,
  ``max_new=8``): the reference drops the out-of-range cache writes and
  goes on, and so does the port;
* ``cache_len`` above a local layer's window: the reference's splice
  raises, and so does the port's, naming the window; at the window both
  serve the same tokens;
* the splice of a prompt's cache into a pooled slot behind the stacked
  group axis, on every cache leaf of a stacked architecture;
* an architecture of each state kind (RG-LRU + local ring, RWKV, MoE)
  served by both (MLA's latent cache through the splice alone: the
  reference's server takes 24 s to serve it here);
* the encoder-decoder's ``Server`` raises as the reference's does (its
  prefill needs ``enc_frames``, which the server never passes);
* ``launch.serve`` serves every request on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import model_init as j_model_init  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.serve_step import Request as JRequest  # noqa: E402
from repro.serve.serve_step import Server as JServer  # noqa: E402
from repro.serve.serve_step import _splice as j_splice  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import Request, Server  # noqa: E402
from repro_torch.serve.serve_step import _splice  # noqa: E402


def _models(arch):
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    jp = jax.jit(lambda key: j_model_init(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu")


@pytest.fixture(scope="module")
def small_model():
    return _models("smollm-135m")


def _serve(server, prompts, max_new, max_steps=32):
    """Submit ``prompts`` as the server's own package's requests, run."""
    make = JRequest if isinstance(server, JServer) else Request
    reqs = [make(prompt=p, max_new=max_new) for p in prompts]
    for r in reqs:
        server.submit(r)
    done = server.run(max_steps=max_steps)
    return reqs, done


def _both(model, prompts, max_new, slots=2, cache_len=32, max_steps=32):
    """The reference's and the port's requests after serving ``prompts``
    on servers of the same shape; the two must give the same tokens."""
    jcfg, cfg, jp, p = model
    jreqs, jdone = _serve(JServer(jcfg, jp, slots=slots,
                                  cache_len=cache_len), prompts, max_new,
                          max_steps)
    reqs, done = _serve(Server(cfg, p, slots=slots, cache_len=cache_len),
                        prompts, max_new, max_steps)
    assert len(done) == len(jdone)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    return reqs, done


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def test_server_max_new_one_not_dropped(small_model):
    reqs, done = _both(small_model, _prompts(256, [4, 4, 4], 0), max_new=1,
                       max_steps=16)
    assert len(done) == 3
    assert all(r.done and len(r.out) == 1 for r in reqs)


def test_server_mixed_length_parity(small_model):
    """Each of two mixed-length prompts decodes at its own position: the
    batched tokens equal the reference's batched run, and each prompt's
    solo run on the port's server (the reference's own test holds its
    batched run to its solo runs)."""
    _, cfg, _, p = small_model
    pa, pb = _prompts(256, [3, 11], 1)
    (qa, qb), done = _both(small_model, [pa, pb], max_new=6)
    assert len(done) == 2
    for q, prompt in ((qa, pa), (qb, pb)):
        (solo,), _ = _serve(Server(cfg, p, slots=2, cache_len=32), [prompt],
                            6)
        assert q.out == solo.out


def test_server_prompt_bound_check(small_model):
    _, cfg, _, p = small_model
    srv = Server(cfg, p, slots=1, cache_len=16)
    with pytest.raises(ValueError, match="cache_len"):
        srv.submit(Request(prompt=np.zeros(17, np.int32)))


def test_server_decodes_past_cache_len_like_reference(small_model):
    """``cache_len=8``, a 6-token prompt, ``max_new=8``: positions 8-12
    lie past the cache; their writes are dropped and decoding goes on."""
    jcfg, cfg, jp, p = small_model
    (prompt,) = _prompts(cfg.vocab, [6], 2)
    jsrv = JServer(jcfg, jp, slots=2, cache_len=8)
    srv = Server(cfg, p, slots=2, cache_len=8)
    (jreq,), _ = _serve(jsrv, [prompt], 8)
    (req,), _ = _serve(srv, [prompt], 8)
    assert len(req.out) == 8 and req.out == jreq.out
    assert list(srv.pos) == list(jsrv.pos) == [13, 0]


@pytest.fixture(scope="module")
def gemma3():
    return _models("gemma3-1b")


def test_server_cache_len_above_window_raises_like_reference(gemma3):
    """A local layer's pool is a ring of ``window`` rows; a prompt's
    cache of ``cache_len`` rows does not fit it.  Both packages raise at
    the splice; at ``cache_len == window`` both serve the same tokens."""
    jcfg, cfg, jp, p = gemma3
    prompts = _prompts(cfg.vocab, [6], 3)
    with pytest.raises(TypeError, match="update shape"):
        _serve(JServer(jcfg, jp, slots=2, cache_len=2 * cfg.window),
               prompts, 4)
    with pytest.raises(ValueError, match=f"window={cfg.window}"):
        _serve(Server(cfg, p, slots=2, cache_len=2 * cfg.window), prompts, 4)
    _both(gemma3, prompts, max_new=4, cache_len=cfg.window)


@pytest.mark.parametrize("slot", [0, 2])
@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v2-236b"])
def test_splice_finds_the_batch_axis_behind_the_group_axis(arch, slot):
    """Every leaf of a stacked pool (group axis first, then the slots;
    MLA's empty ``v`` too) takes a prompt's batch-1 cache at ``slot`` as
    the reference's splice puts it there."""
    jcfg = j_get_reduced(arch)
    rng = np.random.default_rng(slot)
    jpool = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), JT.init_cache(jcfg, 3, 16))
    jone = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), JT.init_cache(jcfg, 1, 16))
    want = jax.tree.map(lambda a, b: np.asarray(j_splice(a, b, slot)),
                        jpool, jone)
    pool, one = params_from_jax(jpool, "cpu"), params_from_jax(jone, "cpu")
    got = jax.tree.map(lambda a, b: _splice(a, b, slot), pool, one)
    leaves = jax.tree.leaves(got)
    assert any(x.ndim >= 4 and x.shape[1] == 3 for x in leaves)
    for g, w in zip(leaves, jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b",
                                  "granite-moe-1b-a400m"])
def test_server_matches_reference_on_each_state_kind(arch):
    model = _models(arch)
    window = model[1].window or 16
    reqs, done = _both(model, _prompts(256, [5, 2, 9], 4), max_new=4,
                       slots=2, cache_len=min(16, window))
    assert len(done) == 3 and all(len(r.out) == 4 for r in reqs)


def test_encoder_decoder_server_raises_like_reference():
    jcfg, cfg, jp, p = _models("seamless-m4t-large-v2")
    prompts = _prompts(cfg.vocab, [4], 5)
    with pytest.raises(KeyError, match="enc_frames"):
        _serve(JServer(jcfg, jp, slots=1, cache_len=8), prompts, 2)
    with pytest.raises(KeyError, match="enc_frames"):
        _serve(Server(cfg, p, slots=1, cache_len=8), prompts, 2)


def test_launch_serve_serves_every_request(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--requests", "5", "--max-new", "3",
                       "--device", "cpu"])
    assert len(done) == 5 and all(len(r.out) == 3 for r in done)
    assert "served 5/5 requests" in capsys.readouterr().out


def test_server_on_the_card_is_the_params_device():
    """The server keeps its caches where the params are, and runs there:
    CPU params serve on the CPU, with no card asked for."""
    cfg = get_reduced("smollm-135m")
    p, _ = TT.model_init(cfg, 0, device="cpu")
    srv = Server(cfg, p, slots=2, cache_len=16)
    assert all(x.device.type == "cpu"
               for x in jax.tree.leaves(srv.caches))
    (req,), _ = _serve(srv, _prompts(cfg.vocab, [3], 6), 2)
    assert len(req.out) == 2
