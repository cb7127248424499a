"""The image benchmark (reference ``benchmark/paddle/image/{smallnet_mnist_
cifar,alexnet,googlenet,vgg}.py`` and the ResNets of
``v1_api_demo/model_zoo/resnet`` and ``resnet_cifar10``) in one config,
in the reference's config idiom: it imports only
``paddle.trainer_config_helpers``, so the port's and the JAX package's
``parse_config`` and ``paddle train`` CLIs both run it.

    python -m paddle_tpu_torch train --job time \
        --config paddle_tpu_torch/configs/image.py \
        --config_args model=alexnet,batch_size=64,num_samples=1472

``--config_args model=smallnet|alexnet|googlenet|vgg|resnet|resnet_cifar10``
(vgg is VGG-19, resnet ResNet-50, resnet_cifar10 its 32-layer net),
``batch_size`` (64) and ``num_samples`` (2048).  data (``3·side²``
floats) → the net → softmax → classification cost; momentum 0.9,
learning rate 0.01 / B, L2 0.0005·B.  The samples come from
``provider.py`` beside this file: uniform(−1, 1) pixels and labels from
``RandomState(0)``.
"""

from paddle.trainer_config_helpers import *  # noqa: F401,F403

model = get_config_arg('model', str, 'smallnet')
batch_size = get_config_arg('batch_size', int, 64)
num_samples = get_config_arg('num_samples', int, 2048)

dims = {'smallnet': (32, 10), 'resnet_cifar10': (32, 10),
        'alexnet': (227, 1000), 'googlenet': (224, 1000),
        'vgg': (224, 1000), 'resnet': (224, 1000)}
side, num_class = dims[model]

args = {'height': side, 'width': side, 'color': True,
        'num_class': num_class, 'num_samples': num_samples}
define_py_data_sources2(None, None, module="provider", obj="process",
                        args=args)

settings(
    batch_size=batch_size,
    learning_rate=0.01 / batch_size,
    learning_method=MomentumOptimizer(0.9),
    regularization=L2Regularization(0.0005 * batch_size))


def conv(net, fs, nf, stride=1, pad=None, channels=None, act=None):
    return img_conv_layer(net, filter_size=fs, num_filters=nf,
                          stride=stride,
                          padding=fs // 2 if pad is None else pad,
                          num_channels=channels,
                          act=act or ReluActivation())


def pool(net, size=3, stride=2, pad=0, avg=False):
    return img_pool_layer(net, pool_size=size, stride=stride, padding=pad,
                          pool_type=AvgPooling() if avg else MaxPooling())


def fc_drop(net):
    return fc_layer(net, size=4096, act=ReluActivation(),
                    layer_attr=ExtraAttr(drop_rate=0.5))


def smallnet(img):
    net = conv(img, 5, 32, 1, 2, channels=3)
    net = pool(net, 3, 2, 1)
    net = conv(net, 5, 32, 1, 2)
    net = pool(net, 3, 2, 1, avg=True)
    net = conv(net, 3, 64, 1, 1)
    net = pool(net, 3, 2, 1, avg=True)
    return fc_layer(net, size=64, act=ReluActivation())


def alexnet(img):
    net = conv(img, 11, 96, 4, 1, channels=3)
    net = img_cmrnorm_layer(net, size=5, scale=0.0001, power=0.75)
    net = pool(net)
    net = conv(net, 5, 256, 1, 2)
    net = img_cmrnorm_layer(net, size=5, scale=0.0001, power=0.75)
    net = pool(net)
    net = conv(net, 3, 384, 1, 1)
    net = conv(net, 3, 384, 1, 1)
    net = conv(net, 3, 256, 1, 1)
    net = pool(net)
    return fc_drop(fc_drop(net))


def vgg19(img):
    net = img
    for i, nf in enumerate((64, 128, 256, 512, 512)):
        net = img_conv_group(net, conv_num_filter=[nf] * (2 if i < 2 else 4),
                             conv_filter_size=3, conv_act=ReluActivation(),
                             pool_size=2, pool_stride=2,
                             num_channels=3 if i == 0 else None)
    return fc_drop(fc_drop(net))


def inception(name, net, channels, f1, f3r, f3, f5r, f5, proj):
    cov1 = conv(net, 1, f1, 1, 0, channels=channels)
    cov3 = conv(conv(net, 1, f3r, 1, 0, channels=channels), 3, f3, 1, 1)
    cov5 = conv(conv(net, 1, f5r, 1, 0, channels=channels), 5, f5, 1, 2)
    covprj = conv(pool(net, 3, 1, 1), 1, proj, 1, 0)
    out = concat_layer([cov1, cov3, cov5, covprj], name=name + "_concat")
    out.channels = f1 + f3 + f5 + proj
    out.img_size, out.img_size_y = cov1.img_size, cov1.img_size_y
    out.size = out.channels * out.img_size * out.img_size_y
    return out


def googlenet(img):
    net = conv(img, 7, 64, 2, 3, channels=3)
    net = pool(net, 3, 2, 1)
    net = conv(net, 1, 64, 1, 0)
    net = conv(net, 3, 192, 1, 1)
    net = pool(net, 3, 2, 1)
    net = inception("i3a", net, 192, 64, 96, 128, 16, 32, 32)
    net = inception("i3b", net, 256, 128, 128, 192, 32, 96, 64)
    net = pool(net, 3, 2, 1)
    net = inception("i4a", net, 480, 192, 96, 208, 16, 48, 64)
    net = inception("i4b", net, 512, 160, 112, 224, 24, 64, 64)
    net = inception("i4c", net, 512, 128, 128, 256, 24, 64, 64)
    net = inception("i4d", net, 512, 112, 144, 288, 32, 64, 64)
    net = inception("i4e", net, 528, 256, 160, 320, 32, 128, 128)
    net = pool(net, 3, 2, 1)
    net = inception("i5a", net, 832, 256, 160, 320, 32, 128, 128)
    net = inception("i5b", net, 832, 384, 192, 384, 48, 128, 128)
    net = pool(net, 7, 1, 0, avg=True)
    return dropout_layer(net, dropout_rate=0.4)


def bn_conv(net, fs, nf, stride=1, pad=None, channels=None, linear=False):
    net = conv(net, fs, nf, stride, pad, channels=channels,
               act=LinearActivation())
    return batch_norm_layer(net, act=LinearActivation() if linear
                            else ReluActivation())


def residual(short, main):
    out = addto_layer([short, main], act=ReluActivation())
    out.channels = main.channels
    out.img_size, out.img_size_y = main.img_size, main.img_size_y
    return out


def shortcut(net, out_ch, stride):
    if getattr(net, "channels", None) != out_ch or stride != 1:
        return bn_conv(net, 1, out_ch, stride, 0, linear=True)
    return net


def basic_block(net, ch, stride):
    short = shortcut(net, ch, stride)
    net = bn_conv(net, 3, ch, stride, 1)
    return residual(short, bn_conv(net, 3, ch, 1, 1, linear=True))


def bottleneck(net, ch, stride):
    short = shortcut(net, ch * 4, stride)
    net = bn_conv(net, 1, ch, stride, 0)
    net = bn_conv(net, 3, ch, 1, 1)
    return residual(short, bn_conv(net, 1, ch * 4, 1, 0, linear=True))


def resnet50(img):
    net = bn_conv(img, 7, 64, 2, 3, channels=3)
    net = pool(net, 3, 2, 1)
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for i in range(blocks):
            net = bottleneck(net, 64 * 2 ** stage,
                             2 if stage > 0 and i == 0 else 1)
    return pool(net, 7, 1, 0, avg=True)


def resnet_cifar10(img):
    net = bn_conv(img, 3, 16, 1, 1, channels=3)
    for ch, first_stride in ((16, 1), (32, 2), (64, 2)):
        for i in range(5):
            net = basic_block(net, ch, first_stride if i == 0 else 1)
    return pool(net, 8, 1, 0, avg=True)


bodies = {'smallnet': smallnet, 'alexnet': alexnet, 'googlenet': googlenet,
          'vgg': vgg19, 'resnet': resnet50,
          'resnet_cifar10': resnet_cifar10}
img = data_layer('data', dense_vector(side * side * 3), height=side,
                 width=side)
net = fc_layer(bodies[model](img), size=num_class, act=SoftmaxActivation())
lab = data_layer('label', integer_value(num_class))
loss = classification_cost(net, lab)
outputs(loss)
