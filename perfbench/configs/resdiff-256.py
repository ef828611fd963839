"""The ResDiff serving chain at 256^2 (``resdiff-256.json``): the port's modules, and the reference beside them.

The program is ``mrisr_torch``'s ``ResDiffPipeline`` over ``SimpleCNN`` and
``ResDiffUNet`` at the configuration's widths, with the traffic's profile
(``options``: ``ca_kv_pool``, ``conv_int8``), its weights made by the
benchmark from the seed on the card, in the served dtype.  A request is one
batch of LR slices with its starting noise, both made from the seed and held
on the card from set-up; it is served by ``super_resolve``, a CUDA-graph
replay.  The check runs ``perfbench/reference/resdiff.py`` in float32 on the
same weights and inputs.
"""
from __future__ import annotations

import gc

import torch

from perfbench import compare, flops, weights
from perfbench.reference import resdiff as ref

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
STREAM_WEIGHTS, STREAM_LR, STREAM_NOISE = 1, 2, 3
ADAM_B1 = 0.9  # the optimizer's first-moment decay (``make_optimizer``'s and the reference's default)


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str = "cuda", options: dict | None = None):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.options = {**traffic.get("options", {}), **(options or {})}
        self.dtype = DTYPES[config["precision"]["activations"]]
        self.precision = config["precision"]
        self.batch, self.size = traffic["batch"], config["image_size"]

    # ---- the reference's modules (shapes on ``meta``, values from the benchmark's weights) ----

    def reference_modules(self, device):
        c = self.cfg
        with torch.device(device):
            cnn = ref.SimpleCNN(c["cnn_hidden"])
            unet = ref.ResDiffUNet(c["image_size"], c["inner_channel"], c["channel_mults"], c["res_blocks"],
                                   c["attn_res"], c["norm_groups"], self.options.get("ca_kv_pool", 0),
                                   c["ca_kv_pool_min_tokens"])
        return cnn, unet

    def weights(self):
        """The benchmark's weights of both modules, ``{"cnn": {...}, "unet": {...}}``, in the served dtype."""
        cnn, unet = self.reference_modules("meta")
        wdtype = DTYPES[self.cfg["precision"]["weights"]]
        return {"cnn": weights.make(weights.ranges(cnn), self.seed, STREAM_WEIGHTS, wdtype, self.device),
                "unet": weights.make(weights.ranges(unet), self.seed, STREAM_WEIGHTS + 10, wdtype, self.device)}

    # ---- the program ----

    def setup(self) -> None:
        from mrisr_torch.diffusion.schedules import make_schedule
        from mrisr_torch.models.resdiff_unet import ResDiffUNet
        from mrisr_torch.models.simple_cnn import SimpleCNN
        from mrisr_torch.pipelines.resdiff import ResDiffPipeline

        c = self.cfg
        cnn = SimpleCNN(hidden=c["cnn_hidden"], device=self.device)
        unet = ResDiffUNet(image_size=c["image_size"], inner_channel=c["inner_channel"],
                           channel_mults=tuple(c["channel_mults"]), res_blocks=c["res_blocks"],
                           attn_res=tuple(c["attn_res"]), norm_groups=c["norm_groups"], dropout=c["dropout"],
                           ca_kv_pool=self.options.get("ca_kv_pool", 0),
                           ca_kv_pool_min_tokens=c["ca_kv_pool_min_tokens"],
                           conv_int8=self.options.get("conv_int8", False), device=self.device)
        wdtype = DTYPES[c["precision"]["weights"]]
        cnn, unet = cnn.to(wdtype), unet.to(wdtype)
        w = self.weights()
        weights.load(cnn, w["cnn"])
        weights.load(unet, w["unet"])
        del w
        sched = make_schedule("linear", c["timesteps"], c["beta_start"], c["beta_end"])
        self.pipe = ResDiffPipeline(cnn, unet, sched, device=self.device)
        self.lr, self.x_T = self.make_inputs(self.traffic["pool"])
        out = self.serve(0)  # captures the chain's graph
        self.serve(1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("the warm-up chain gave non-finite output")

    def reseed(self, seed: int) -> None:
        """Weights and inputs of another seed, written in place (a captured graph stays valid)."""
        self.seed = seed
        w = self.weights()
        weights.load(self.pipe.cnn, w["cnn"])
        weights.load(self.pipe.unet, w["unet"])
        lr, x_T = self.make_inputs(self.lr.shape[0])
        self.lr.copy_(lr)
        self.x_T.copy_(x_T)

    def make_inputs(self, n: int):
        """``n`` requests' LR slices (uniform in [-1, 1]) and starting noise, ``[n, B, H, W, 1]`` each."""
        shape = (n, self.batch, self.size, self.size, 1)
        g_lr = weights.generator(self.seed, STREAM_LR, device=self.device)
        g_x = weights.generator(self.seed, STREAM_NOISE, device=self.device)
        lr = (torch.rand(shape, generator=g_lr, device=self.device) * 2.0 - 1.0).to(self.dtype)
        x_T = torch.randn(shape, generator=g_x, device=self.device).to(self.dtype)
        return lr, x_T

    def request(self, i: int) -> int:
        return i % self.lr.shape[0]

    def items(self, req: int) -> int:
        return self.batch

    def serve(self, req: int) -> torch.Tensor:
        return self.pipe.super_resolve(self.lr[req], x_T=self.x_T[req], num_steps=self.cfg["num_steps"],
                                       spacing=self.cfg["spacing"])

    @staticmethod
    def finite(out: torch.Tensor) -> bool:
        return bool(torch.isfinite(out).all())

    def release(self) -> None:
        del self.pipe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the work a request asks for, from the reference at the cell's shapes ----

    def work(self) -> dict:
        cnn, unet = self.reference_modules("meta")
        b, s, steps = self.batch, self.size, self.cfg["num_steps"]
        lr = torch.zeros((b, 1, s, s), device="meta")
        sites = ref.Work()
        # Chains of one and of two steps: stage 1 and the static features once, then the UNet call a step.
        one = flops.count(lambda: ref.chain(cnn, unet, lr, lr, 1, self.cfg["timesteps"], sites))
        two = flops.count(lambda: ref.chain(cnn, unet, lr, lr, 2, self.cfg["timesteps"]))
        counted = {op: one.get(op, 0.0) + (steps - 1) * (two[op] - one.get(op, 0.0)) for op in two}
        act = self.cfg["precision"]["activations"]
        return {"flops": [{"ops": counted, "precision": self.cfg["flop_precision"]}],
                "attention": [dict(b=bb, n=n, m=m, d=d, precision=act, count=steps) for bb, n, m, d in sites.attention
                              if n >= self.cfg["attention_kernel_min_queries"]],
                "gn_silu": [dict(shape=shape, groups=g, precision=act, param_precision=self.cfg["precision"]["weights"],
                                 count=steps) for shape, g in sites.gn_silu]}

    # ---- the check ----

    def loaded_reference(self):
        """The reference's modules on the device, holding the benchmark's weights in float32."""
        cnn, unet = self.reference_modules(self.device)
        w = self.weights()
        weights.load(cnn, {k: v.float() for k, v in w["cnn"].items()})
        weights.load(unet, {k: v.float() for k, v in w["unet"].items()})
        return cnn, unet

    def reference_chain(self, cnn, unet, req: int):
        """The reference's chain on request ``req``'s inputs: ``(sr, stage-1 estimate)``, NCHW float32."""
        nchw = lambda t: t.float().reshape(self.batch, 1, self.size, self.size)  # noqa: E731
        return ref.chain(cnn, unet, nchw(self.lr[req]), nchw(self.x_T[req]), self.cfg["num_steps"],
                         self.cfg["timesteps"])

    @torch.no_grad()
    def check(self, samples: list[tuple[int, torch.Tensor]]) -> dict[str, float]:
        """The served outputs ``samples`` (request, output) against the float32 reference on the same weights
        and inputs, slice by slice (``compare.numbers``), each gap against what the diffusion chain adds to the
        reference's stage-1 estimate: ||out - ref|| / ||ref - ref_stage1||."""
        cnn, unet = self.loaded_reference()
        gaps = []
        for req, out in samples:
            sr, cnn_sr = self.reference_chain(cnn, unet, req)
            gaps.append(compare.slice_gaps(out.float().reshape(sr.shape), sr, cnn_sr))
        return compare.numbers(gaps)

    @torch.no_grad()
    def control(self, reqs: list[int]) -> list[tuple[int, torch.Tensor]]:
        """The check's control: the reference put in the program's place and computed one precision below the
        served bf16 (``reference/lowp.py``: every product's operands in float8 e4m3), on the same weights and
        inputs; ``[(request, output)]`` as ``serve`` answers."""
        from perfbench.reference import lowp

        cnn, unet = self.loaded_reference()
        with lowp.fp8_products(cnn, unet):
            return [(req, self.reference_chain(cnn, unet, req)[0].reshape(self.batch, self.size, self.size, 1))
                    for req in reqs]


class TrainSystem:
    """Stage-2 training as ``train-resdiff --cache`` runs it: the loader's prefetch thread over a slice cache,
    the stage-1 estimate, then the graphed training step (Adam, EMA, dropout from each step's generator).

    Set-up writes the cache from pairs made from the seed, builds the step with its state, and drives it
    through its first ``check_steps`` steps by the window's own call and feed, keeping what the check reads:
    the batches, the losses, the first gradient as the optimizer holds it after one step (Adam's first moment
    over 1 - beta1), and the parameters and their EMA after the last.  The window then runs on from there.
    """

    def __init__(self, config: dict, traffic: dict, seed: int, device: str = "cuda", options: dict | None = None):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.options = {**traffic.get("options", {}), **(options or {})}
        self.train = config["train"]
        self.precision = self.train["precision"]
        self.batch, self.size = traffic["batch"], config["image_size"]
        self.model = System(config, traffic, seed, device, options)

    def generator(self, step: int) -> torch.Generator:
        """The generator of step ``step``: the program's draws (t, gamma, eps, dropout) and the reference's."""
        return weights.generator(self.seed, 100, step, device=self.device)

    def weights(self):
        w = self.model.weights()
        return {part: {k: v.float() for k, v in tree.items()} for part, tree in w.items()}

    def write_cache(self, path) -> None:
        """``pairs`` (LR, HR) slices, uniform in [-1, 1], made on the card from the seed, written as a slice cache."""
        from mrisr_torch.data.slicecache import SliceCache

        n, s = self.traffic["pairs"], self.size
        g = weights.generator(self.seed, STREAM_LR, device=self.device)
        pairs = (torch.rand((2, n, s, s), generator=g, device=self.device) * 2.0 - 1.0).cpu().numpy()
        cache = SliceCache.create(path, n, s, s)
        try:
            for i in range(n):
                cache.write(i, pairs[0, i], pairs[1, i])
        finally:
            cache.close()

    def setup(self) -> None:
        import tempfile

        from mrisr_torch.data.loader import Loader
        from mrisr_torch.data.slicecache import SliceCacheDataset
        from mrisr_torch.diffusion.schedules import make_schedule
        from mrisr_torch.models.resdiff_unet import ResDiffUNet
        from mrisr_torch.models.simple_cnn import SimpleCNN
        from mrisr_torch.train.precision import get_policy
        from mrisr_torch.train.state import create_train_state, make_optimizer
        from mrisr_torch.train.steps import make_resdiff_train_step

        c, t = self.cfg, self.train
        self.tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
        path = f"{self.tmp.name}/slices.bin"
        self.write_cache(path)
        self.dataset = SliceCacheDataset(path)
        loader = Loader(self.dataset, batch_size=self.batch, shuffle=True, seed=weights.sub_seed(self.seed, 5),
                        pin_memory=self.device.type == "cuda")
        self.batches = loader.batches()
        w = self.weights()
        self.cnn = SimpleCNN(hidden=c["cnn_hidden"], device=self.device).eval()
        weights.load(self.cnn, w["cnn"])
        unet = ResDiffUNet(image_size=c["image_size"], inner_channel=c["inner_channel"],
                           channel_mults=tuple(c["channel_mults"]), res_blocks=c["res_blocks"],
                           attn_res=tuple(c["attn_res"]), norm_groups=c["norm_groups"], dropout=c["dropout"],
                           device=self.device)
        weights.load(unet, w["unet"])
        del w
        self.state = create_train_state(unet, make_optimizer(t["lr"]), ema_decay=t["ema_decay"], device=self.device)
        sched = make_schedule("linear", c["timesteps"], c["beta_start"], c["beta_end"])
        policy = get_policy(self.options.get("policy", t["policy"]))
        self.step = make_resdiff_train_step(unet, sched, policy, device=self.device)
        self.i = 0
        # The first steps, through the window's own call and feed, kept for the check.
        self.kept = {"batches": [], "losses": []}
        for _ in range(self.traffic["check_steps"]):
            batch = self.next_batch()
            self.kept["batches"].append(tuple(torch.as_tensor(batch[k]).clone() for k in ("lr", "hr")))
            self.kept["losses"].append(self.train_step(batch)["loss"])
            if self.i == 1:
                self.kept["grads"] = {k: v / (1.0 - ADAM_B1) for k, v in self.state.opt_state["mu"].items()}
        self.kept["params"] = {k: v.clone() for k, v in self.state.params.items()}
        self.kept["ema"] = {k: v.clone() for k, v in self.state.ema_params.items()}
        self.kept["losses"] = [float(x) for x in self.kept["losses"]]

    def next_batch(self) -> dict:
        return next(self.batches)

    def items(self, batch) -> int:
        return self.batch

    def train_step(self, batch: dict) -> dict:
        lr, hr = (torch.as_tensor(batch[k]).to(self.device, torch.float32, non_blocking=True) for k in ("lr", "hr"))
        with torch.no_grad():
            b, h, w, _ = lr.shape
            sr = self.cnn(lr.reshape(b, 1, h, w)).reshape(b, h, w, 1)
        self.state, metrics = self.step(self.state, {"sr": sr, "hr": hr}, self.generator(self.i))
        self.i += 1
        return metrics

    @staticmethod
    def finite(out) -> bool:
        return True

    def release(self) -> None:
        self.batches.close()
        del self.state, self.step, self.cnn, self.batches
        self.dataset.cache.close()
        self.tmp.cleanup()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def work(self) -> dict:
        """A step's operations (the stage-1 estimate, the UNet's forward and backward) and its kernels' sites."""
        from perfbench.reference import resdiff_train as ref_train

        c = self.cfg
        cnn, _ = self.model.reference_modules("meta")
        with torch.device("meta"):
            unet = ref.ResDiffUNet(c["image_size"], c["inner_channel"], c["channel_mults"], c["res_blocks"],
                                   c["attn_res"], c["norm_groups"], dropout=c["dropout"])
        b, s = self.batch, self.size
        x = torch.zeros((b, 1, s, s), device="meta")
        params = {k: v.requires_grad_(True) for k, v in unet.named_parameters()}
        tables = ref_train.schedule_tables(c["timesteps"], c["beta_start"], c["beta_end"], "meta")

        def step():
            value = ref_train.loss(cnn, unet, params, x, x, None, tables)  # dropout's masks carry no FLOPs
            torch.autograd.grad(value, list(params.values()), allow_unused=True)

        counted = flops.count(step)
        sites = ref.Work()
        unet(torch.zeros((b, 2, s, s), device="meta"), torch.zeros((b,), device="meta"), None, sites)
        act = self.train["activations"]
        return {"flops": [{"ops": counted, "precision": self.train["flop_precision"]}],
                "attention": [dict(b=bb, n=n, m=m, d=d, precision=act, count=1) for bb, n, m, d in sites.attention
                              if n >= self.cfg["attention_kernel_min_queries"]],
                "gn_silu": [dict(shape=shape, groups=g, precision=act, param_precision=act, count=1)
                            for shape, g in sites.gn_silu]}

    def check(self, samples) -> dict[str, float]:
        """The first steps against the reference's on the same weights, batches and generators: the loss of each
        step; by the worst leaf (``compare.leaf_gap``) the first gradient and the parameters' change after the
        last step; and by the median leaf the EMA's change (``ema_gap``; its worst leaf, ``ema_gap_worst``, is
        rounding where three steps move a leaf at magnitude 1 by under one float32 ulp); all of the leaves the
        reference's gradient moves (``compare.moving_leaves``)."""
        from perfbench.reference import resdiff_train as ref_train

        c = self.cfg
        cnn, _ = self.model.reference_modules(self.device)
        with torch.device(self.device):
            unet = ref.ResDiffUNet(c["image_size"], c["inner_channel"], c["channel_mults"], c["res_blocks"],
                                   c["attn_res"], c["norm_groups"], dropout=c["dropout"])
        w = self.weights()
        weights.load(cnn, w["cnn"])
        start = w["unet"]
        tables = ref_train.schedule_tables(c["timesteps"], c["beta_start"], c["beta_end"], self.device)
        nchw = lambda t: t.to(self.device).float().reshape(self.batch, 1, self.size, self.size)  # noqa: E731
        batches = [(nchw(lr), nchw(hr)) for lr, hr in self.kept["batches"]]
        gens = [self.generator(i) for i in range(len(batches))]
        losses, grads, opt, ema = ref_train.train(cnn, unet, start, batches, gens, tables, self.train["lr"],
                                                  self.train["ema_decay"])
        loss_gap = max(abs(p - r) / abs(r) for p, r in zip(self.kept["losses"], losses))
        kept = compare.moving_leaves(grads)
        delta = lambda tree: {k: tree[k] - start[k] for k in kept}  # noqa: E731
        return {"loss_gap": loss_gap,
                "grad_gap": compare.leaf_gap(self.kept["grads"], grads),
                "change_gap": compare.leaf_gap(delta(self.kept["params"]), delta(opt.params)),
                "ema_gap": compare.median_leaf_gap(delta(self.kept["ema"]), delta(ema)),
                "ema_gap_worst": compare.leaf_gap(delta(self.kept["ema"]), delta(ema))}
