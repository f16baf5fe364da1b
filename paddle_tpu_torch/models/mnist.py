"""LeNet-5-style MNIST convnet and MLP, the recognize_digits book
config (counterpart of paddle_tpu/models/mnist.py)."""
from __future__ import annotations

from .. import layers, nets


def lenet5(img, is_test=False):
    conv_pool_1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act='relu')
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act='relu')
    return layers.fc(input=conv_pool_2, size=10, act='softmax')


def mlp(img):
    hidden = layers.fc(input=img, size=200, act='tanh')
    hidden = layers.fc(input=hidden, size=200, act='tanh')
    return layers.fc(input=hidden, size=10, act='softmax')


def train_network(img, label, nn_type='conv'):
    predict = lenet5(img) if nn_type == 'conv' else mlp(img)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc
