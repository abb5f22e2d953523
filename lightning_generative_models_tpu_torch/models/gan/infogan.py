"""InfoGAN (Chen et al. 2016): interpretable codes through a mutual-information loss.

Counterpart of ``lightning_generative_models_tpu/models/gan/infogan.py``: G is DCGAN's
``ConvGenerator`` (bf16 convs, as the JAX class builds it) on [z, one-hot categorical
code, continuous codes]; D (``QDiscriminator``, f32) is ACGAN's conv stack with a
real/fake Dense head and a Q head (Dense 128, BatchNorm, LeakyReLU(0.2), Dense to the
categorical logits, the continuous means and log-variances).

Three optimizers: "D" on D, "G" on G, and "Q", an Adam with G's settings over G and D
together, with its own state. A step: the GAN base's D phase and G phase (G once, BCE
losses, G's loss through the stepped D), then the Q phase: G (stepped) and D (stepped) in
train mode again on the same codes, MI = lambda_cat CE(cat) + lambda_cont NLL(cont), and
"Q" steps both. Recomputing with the stepped nets is the JAX package's documented
deviation from the reference (which applied pre-update gradients); it is ported as it
is. G's running statistics move twice a step (the shared G pass, then the Q phase), D's
four times (real, fake, the G phase, the Q phase).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import refuse_sampler_options
from lightning_generative_models_tpu_torch.models.diffusion.gaussian_diffusion import call_chain
from lightning_generative_models_tpu_torch.models.gan.acgan import ConvFeatures
from lightning_generative_models_tpu_torch.models.gan.dcgan import ConvGenerator
from lightning_generative_models_tpu_torch.models.gan.gan import GAN
from lightning_generative_models_tpu_torch.models.modules.layers import BatchNorm, Dense
from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib
from lightning_generative_models_tpu_torch.train.state import make_adam
from lightning_generative_models_tpu_torch.utils.draws import Draw

Codes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def gaussian_nll(x: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """The diagonal Gaussian's NLL without the log(2 pi) term, summed over the codes and
    averaged over the batch."""
    return (0.5 * (logvar + (x - mu) ** 2 / torch.exp(logvar)).sum(dim=-1)).mean()


class QDiscriminator(ConvFeatures):
    """Images -> (real/fake logit [B], categorical logits, continuous mu, logvar)."""

    def __init__(self, img_size: int, img_channels: int, categorical_code_dim: int,
                 continuous_code_dim: int):
        super().__init__(img_size, img_channels)
        self.cat_dim, self.cont_dim = categorical_code_dim, continuous_code_dim
        self.Dense_0 = Dense(self.num_features, 1)
        self.Dense_1 = Dense(self.num_features, 128)
        self.q_norm = f"BatchNorm_{self.n_convs - 1}"
        self.add_module(self.q_norm, BatchNorm(128))
        self.Dense_2 = Dense(128, categorical_code_dim + 2 * continuous_code_dim)

    def forward(self, x: torch.Tensor):
        h = self.features(x)
        logit = self.Dense_0(h)[:, 0]
        q = F.leaky_relu(getattr(self, self.q_norm)(self.Dense_1(h)), 0.2)
        q = self.Dense_2(q)
        c, k = self.cat_dim, self.cont_dim
        return logit, q[:, :c], q[:, c:c + k], q[:, c + k:]


class InfoGAN(GAN):
    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        latent_dim: int = 100,
        categorical_code_dim: int = 10,
        continuous_code_dim: int = 2,
        lambda_cat: float = 1.0,
        lambda_cont: float = 0.1,
        lr: float = 2e-4,
        b1: float = 0.5,
        b2: float = 0.999,
        weight_decay: float = 1e-5,
        calculate_metrics: bool = False,
        metrics: Optional[list] = None,
        summary: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.categorical_code_dim = categorical_code_dim
        self.continuous_code_dim = continuous_code_dim
        self.lambda_cat = lambda_cat
        self.lambda_cont = lambda_cont
        super().__init__(img_channels=img_channels, img_size=img_size, latent_dim=latent_dim,
                         lr=lr, b1=b1, b2=b2, weight_decay=weight_decay,
                         calculate_metrics=calculate_metrics, metrics=metrics,
                         summary=summary, device=device)

    def _build_networks(self) -> Tuple[nn.Module, nn.Module]:
        code_dim = self.latent_dim + self.categorical_code_dim + self.continuous_code_dim
        return (ConvGenerator(code_dim, self.img_size, self.img_channels),
                QDiscriminator(self.img_size, self.img_channels, self.categorical_code_dim,
                               self.continuous_code_dim))

    def _build_optimizers(self) -> Dict[str, torch.optim.Optimizer]:
        optimizers = super()._build_optimizers()
        optimizers["Q"] = make_adam([*self.G.parameters(), *self.D.parameters()], self.lr,
                                    *self.betas, weight_decay=self.weight_decay)
        return optimizers

    def flax_layout(self) -> dict:
        layout = super().flax_layout()
        layout["adam"]["opt_state/Q"] = (self.optimizers["Q"], {"G": self.G, "D": self.D})
        return layout

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.D(x)[0]

    # -- codes -----------------------------------------------------------------------
    def generate_codes(self, generator: Optional[torch.Generator], n: int,
                       structured: bool = False) -> Codes:
        """(z [n, latent], one-hot categorical code [n, cat], continuous codes [n, cont]
        in [0, 1)). ``structured``: the categories step every n // cat rows and the
        continuous codes go linearly from one draw to another down the rows."""
        dev = self.device
        z = torch.randn(n, self.latent_dim, generator=generator, device=dev)
        if structured:
            with mesh_lib.replicated_draws():  # the grid's two ends, every rank's alike
                start = torch.rand(1, self.continuous_code_dim, generator=generator,
                                   device=dev)
                end = torch.rand(1, self.continuous_code_dim, generator=generator,
                                 device=dev)
            return self._structured_codes(z, start, end)
        cats = torch.randint(0, self.categorical_code_dim, (n,), generator=generator,
                             device=dev)
        cont = torch.rand(n, self.continuous_code_dim, generator=generator, device=dev)
        return z, F.one_hot(cats, self.categorical_code_dim).float(), cont

    def _structured_codes(self, z: torch.Tensor, start: torch.Tensor, end: torch.Tensor
                          ) -> Codes:
        """The structured codes of ``z``'s n rows: the categories step every n // cat
        rows, the continuous codes go linearly from ``start`` to ``end`` [1, cont]. Under
        ``global_draws`` the rows are this rank's of the global batch's grid."""
        n, dev = z.shape[0], z.device
        total = mesh_lib.global_rows(n)
        ids = mesh_lib.example_ids(n, dev)
        step = max(total // self.categorical_code_dim, 1)
        cats = (ids // step) % self.categorical_code_dim
        alpha = torch.linspace(0, 1, total, device=dev)
        alpha = (alpha if total == n else alpha[ids])[:, None]
        cont = start * (1 - alpha) + end * alpha
        return z, F.one_hot(cats, self.categorical_code_dim).float(), cont

    def _codes(self, generator, n: int, codes: Optional[Codes], structured: bool = False):
        if codes is None:
            return self.generate_codes(generator, n, structured)
        return tuple(c.to(self.device).float() for c in codes)

    def _mi(self, x_hat: torch.Tensor, cat: torch.Tensor, cont: torch.Tensor):
        _, cat_logits, mu, logvar = self.D(x_hat)
        ce = -(cat * F.log_softmax(cat_logits, dim=-1)).sum(-1).mean()
        nll = gaussian_nll(cont, mu, logvar)
        return self.lambda_cat * ce + self.lambda_cont * nll, ce, nll

    # -- steps -----------------------------------------------------------------------
    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   flip: Optional[torch.Tensor] = None,
                   codes: Optional[Codes] = None) -> Dict[str, torch.Tensor]:
        """The D, G and Q phases (module doc) on a uint8 batch flipped by ``flip`` and the
        ``codes`` (z, one-hot cat, cont), each drawn from ``generator`` when not given."""
        x = self._x(batch, generator, True, flip)
        z, cat, cont = self._codes(generator, x.shape[0], codes)
        zc = torch.cat([z, cat, cont], dim=1)
        self.G.train()
        self.D.train()
        x_hat = self.G(zc)
        d_loss, d_metrics = self._d_loss(x, x_hat.detach())
        self._optimize("D", d_loss, self.D)
        g_loss, g_metrics = self._g_loss(x_hat)
        self._optimize("G", g_loss, self.G)

        mi, ce, nll = self._mi(self.G(zc), cat, cont)
        self._optimize("Q", mi, self.G, self.D)
        self.step += 1
        metrics = {**d_metrics, **g_metrics, "mi_loss": mi, "mi_categorical": ce,
                   "mi_continuous": nll}
        return self.prefix_metrics({k: v.detach() for k, v in metrics.items()}, "train")

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  codes: Optional[Codes] = None) -> Dict[str, torch.Tensor]:
        """The GAN losses, the MI loss and ``loss`` (= g_loss), G and D in eval mode."""
        x = self._x(batch, None, False, None)
        z, cat, cont = self._codes(generator, x.shape[0], codes)
        self.G.eval()
        self.D.eval()
        x_hat = self.G(torch.cat([z, cat, cont], dim=1))
        _, d_metrics = self._d_loss(x, x_hat)
        _, g_metrics = self._g_loss(x_hat)
        mi, _, _ = self._mi(x_hat, cat, cont)
        return self.prefix_metrics({**d_metrics, **g_metrics, "mi_loss": mi,
                                    "loss": g_metrics["g_loss"]}, "val")

    def serving_chain(self, batch_size: int, method=None, steps=None, labels=None):
        """``(chain, parts)`` of ``sample`` (the code-transition grid) for
        ``serving.export_sampler``: z normal [n, latent], then the continuous codes' ends
        ``start`` and ``end`` uniform [1, cont], as ``generate_codes`` draws them; the
        categories and the interpolation are constants of the batch size; G in eval mode."""
        refuse_sampler_options(self, method, steps)
        self.G.eval()
        cont = (1, self.continuous_code_dim)
        chain = call_chain(lambda *draws: self._generate(*self._structured_codes(*draws)),
                           Draw("z", (batch_size, self.latent_dim)),
                           Draw("start", cont, "uniform"), Draw("end", cont, "uniform"))
        return chain, {"G": self.G}

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator], num_samples: int,
               codes: Optional[Codes] = None) -> torch.Tensor:
        """The code-transition grid: structured codes (``generate_codes``), G in eval
        mode; images in [0, 1]."""
        z, cat, cont = self._codes(generator, num_samples, codes, structured=True)
        self.G.eval()
        return self._generate(z, cat, cont)

    def _generate(self, z: torch.Tensor, cat: torch.Tensor, cont: torch.Tensor) -> torch.Tensor:
        return self.to_image_space(self.G(torch.cat([z, cat, cont], dim=1)))

    def validation_grids(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Rows step the categorical code, columns move the continuous codes."""
        return {"code_transition": self.sample(generator, self.categorical_code_dim * 8)}
