"""Helpers of the fleet tests (``test_torch_fleet.py``,
``test_torch_fleet_deploy.py``): a deterministic greedy fake decoder that
both packages' engines drive (scheduler logic without a model), the TINY
transformer's predictors on the same Flax tree in both packages, and the
fleet runs.

The fake's next token is a pure function of the context so far, so a
request re-dispatched as ``prompt + committed`` onto any replica goes on
with the exact sequence (the committed-token rule).
"""

import time

import numpy as np

TINY = {
    "vocab_size": 64, "num_layers": 2, "num_heads": 2, "head_dim": 8,
    "embed_dim": 16, "mlp_dim": 32, "max_seq_len": 96, "dtype": "float32",
}
#: the slice's serving settings at the TINY size (paged, greedy); the JAX
#: side runs its paged decoder through ``paged_impl="gather"``
GEN = dict(mode="generate", kv_layout="paged", kv_page_tokens=8,
           max_new_tokens=6, chunk_size=2, pad_multiple=16,
           max_prompt_len=48)
MAPPING = {"prompt": "tokens"}


def next_token(context):
    return (sum(context) + len(context)) % 50


class FakeDecoder(object):
    """The SlotDecoder surface both engines drive; ``step_chunk`` returns
    ``(tokens, valid)``, which both read."""

    eos_id = None
    cache_len = 4096

    def __init__(self, n, chunk=4, max_new=8, delay=0.0):
        self.num_slots = int(n)
        self.chunk_size = int(chunk)
        self.max_new_tokens = int(max_new)
        self.delay = float(delay)
        self.active = {}
        self.weight_generation = 0
        self.params = "v0"

    def free_slots(self):
        return [i for i in range(self.num_slots) if i not in self.active]

    def admit(self, slot, prompt, new_tokens=None):
        ctx = [int(t) for t in prompt]
        first = next_token(ctx)
        self.active[slot] = ctx + [first]
        return first

    def step_chunk(self):
        if self.delay:
            time.sleep(self.delay)
        out = np.zeros((self.num_slots, self.chunk_size), np.int32)
        for slot, ctx in self.active.items():
            for j in range(self.chunk_size):
                t = next_token(ctx)
                ctx.append(t)
                out[slot, j] = t
        return out, np.full((self.num_slots,), self.chunk_size, np.int32)

    def evict(self, slot):
        self.active.pop(slot, None)

    cancel = evict

    def reset(self):
        self.active.clear()

    # the hot-swap surface (rolling deploys drive it)
    def param_spec(self):
        return {"w": {"shape": [1], "dtype": "float32"}}

    def snapshot_weights(self):
        return self.params

    def swap_weights(self, params, draft_params=None, ready=None):
        if params == "refuse":
            raise ValueError("shape mismatch at w")
        self.params = params
        self.weight_generation += 1

    def restore_weights(self, snapshot):
        self.params = snapshot
        self.weight_generation += 1

    def canary_check(self):
        return self.params != "burn"


class FakePredict(object):
    column_padding = {"tokens": 0}

    def __init__(self, chunk=4, max_new=8, delay=0.0):
        self._args = (chunk, max_new, delay)

    def make_slot_decoder(self, n, chunk=None):
        c, max_new, delay = self._args
        return FakeDecoder(n, chunk=chunk or c, max_new=max_new, delay=delay)


def prompts(lens, vocab=50, seed=7):
    rng = np.random.RandomState(seed)
    return [{"prompt": rng.randint(1, vocab, (n,)).astype(np.int32)}
            for n in lens]


def tokens(out):
    return [np.asarray(r["generated"]).tolist() if "error" not in r
            else ("error", r["error"]["kind"]) for r in out]


def fake_router(router_mod, n=2, slots=2, max_new=8, chunk=4, delay=0.0,
                **kw):
    kw.setdefault("poll_sec", 0.01)
    return router_mod.FleetRouter(
        None, MAPPING, replicas=n, num_slots=slots,
        predict_factory=lambda: FakePredict(chunk=chunk, max_new=max_new,
                                            delay=delay),
        **kw)


def serve(router, rows):
    """``(outputs, router)`` of one stream, the fleet closed after it."""
    try:
        out = list(router.serve([dict(r) for r in rows]))
    finally:
        router.close()
    return out, router


def jax_tree():
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import transformer as jtr

    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def port_predict(tree, **extra):
    from tensorflowonspark_tpu_torch.models import transformer as ttr

    return ttr.serving_builder(tree, dict(TINY, **GEN, device="cpu",
                                          **extra))


def jax_predict(tree, **extra):
    from tensorflowonspark_tpu.models import transformer as jtr

    return jtr.serving_builder(tree, dict(TINY, **GEN, paged_impl="gather",
                                          **extra))


def trio(predict):
    """The predictor and two replicas of it (each its own decoder)."""
    return [predict, predict.make_replica(), predict.make_replica()]


def factory(predicts):
    it = iter(predicts)
    return lambda: next(it)


def real_router(router_mod, predicts, n=3, slots=2, **kw):
    kw.setdefault("poll_sec", 0.01)
    return router_mod.FleetRouter(None, MAPPING, replicas=n, num_slots=slots,
                                  predict_factory=factory(predicts), **kw)


def single(serving_mod, predict, rows, slots=2):
    return list(serving_mod.predict_rows(
        predict, [dict(r) for r in rows], MAPPING, batch_size=slots,
        schedule="continuous"))
