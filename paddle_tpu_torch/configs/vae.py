"""VAE on MNIST (reference ``v1_api_demo/vae/vae_conf.py``; the body of
``demo/vae/vae_conf.py``), in the reference's config idiom: it imports
only ``paddle.trainer_config_helpers``, so the port's and the JAX
package's ``parse_config`` both run it.

    from paddle_tpu_torch.config.config_parser import parse_config
    model, opt, _ = parse_config("paddle_tpu_torch/configs/vae.py", "")
    gen, _, _ = parse_config("paddle_tpu_torch/configs/vae.py",
                             "is_generating=1")

Encoder q(z|x) → (mu, logvar) at x 784, hidden 128, z 100; the
reparameterised z = mu + exp(0.5 logvar) · eps, with eps a data layer
fed per batch (the reference fakes it with a frozen random parameter);
decoder p(x|z); the output is the reconstruction CE plus KL(q || N(0,
1)), written with ``layer_math`` arithmetic.  Batch 32, Adam lr 1e-3.
``is_generating=1`` gives the decoder alone, fed z as ``noise``, its
parameters shared with training by name.
"""
from paddle.trainer_config_helpers import *  # noqa: F401,F403
import numpy as np

is_generating = get_config_arg("is_generating", bool, False)

settings(batch_size=32, learning_rate=1e-3,
         learning_method=AdamOptimizer())

X_dim = 28 * 28
h_dim = 128
z_dim = 100


def q_func(X):
    param_attr = ParamAttr(name="share.w", initial_mean=0.,
                           initial_std=1. / np.sqrt(X_dim / 2.))
    mu_param = ParamAttr(name="mu.w", initial_mean=0.,
                         initial_std=1. / np.sqrt(h_dim / 2.))
    logvar_param = ParamAttr(name="logvar.w", initial_mean=0.,
                             initial_std=1. / np.sqrt(h_dim / 2.))
    bias_attr = ParamAttr(name="share.bias", initial_mean=0.,
                          initial_std=0.)
    mu_bias = ParamAttr(name="mu.bias", initial_mean=0., initial_std=0.)
    logvar_bias = ParamAttr(name="logvar.bias", initial_mean=0.,
                            initial_std=0.)

    share_layer = fc_layer(X, size=h_dim, param_attr=param_attr,
                           bias_attr=bias_attr, act=ReluActivation())
    return (fc_layer(share_layer, size=z_dim, param_attr=mu_param,
                     bias_attr=mu_bias, act=LinearActivation()),
            fc_layer(share_layer, size=z_dim, param_attr=logvar_param,
                     bias_attr=logvar_bias, act=LinearActivation()))


def reparameterization(mu, logvar, eps):
    sigma = layer_math.exp(logvar * 0.5)
    with mixed_layer(size=z_dim) as noise_scaled:
        noise_scaled += dotmul_operator(sigma, eps, scale=1.)
    return mu + noise_scaled


def generator(z):
    hidden_param = ParamAttr(name="hidden.w", initial_mean=0.,
                             initial_std=1. / np.sqrt(z_dim / 2.))
    hidden_bias = ParamAttr(name="hidden.bias", initial_mean=0.,
                            initial_std=0.)
    prob_param = ParamAttr(name="prob.w", initial_mean=0.,
                           initial_std=1. / np.sqrt(h_dim / 2.))
    prob_bias = ParamAttr(name="prob.bias", initial_mean=0.,
                          initial_std=0.)

    hidden_layer = fc_layer(z, size=h_dim, act=ReluActivation(),
                            param_attr=hidden_param,
                            bias_attr=hidden_bias)
    return fc_layer(hidden_layer, size=X_dim, act=SigmoidActivation(),
                    param_attr=prob_param, bias_attr=prob_bias)


def reconstruct_error(prob, X):
    return multi_binary_label_cross_entropy(input=prob, label=X)


def KL_loss(mu, logvar):
    with mixed_layer(size=z_dim) as mu_square:
        mu_square += dotmul_operator(mu, mu, scale=1.)
    return 0.5 * sum_cost(layer_math.exp(logvar) + mu_square
                          - 1. - logvar)


if not is_generating:
    x_batch = data_layer(name="x_batch", size=X_dim)
    eps = data_layer(name="noise", size=z_dim)
    mu, logvar = q_func(x_batch)
    z_samples = reparameterization(mu, logvar, eps)
    prob = generator(z_samples)
    outputs(reconstruct_error(prob, x_batch) + KL_loss(mu, logvar))
else:
    z_samples = data_layer(name="noise", size=z_dim)
    outputs(generator(z_samples))
