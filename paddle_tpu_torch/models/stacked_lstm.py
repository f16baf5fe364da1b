"""The stacked LSTM sentiment classifier (counterpart of
paddle_tpu/models/stacked_lstm.py): embedding -> fc -> a stack of
dynamic LSTMs of alternating direction -> max pools over time ->
softmax, on padded sequences with their lengths."""
from __future__ import annotations

from .. import layers

EMB_DIM = 512
HID_DIM = 512
STACKED_NUM = 3


def stacked_lstm_net(data, input_dim, class_dim=2, emb_dim=EMB_DIM,
                     hid_dim=HID_DIM, stacked_num=STACKED_NUM):
    """`hid_dim` is each LSTM's `size`, 4 * its hidden width."""
    emb = layers.embedding(input=data, size=[input_dim, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim)
    lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim,
                                   use_peepholes=False)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim)
        lstm, _ = layers.dynamic_lstm(
            input=fc, size=hid_dim, is_reverse=(i % 2) == 0,
            use_peepholes=False)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(input=inputs[0], pool_type='max')
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type='max')
    return layers.fc(input=[fc_last, lstm_last], size=class_dim,
                     act='softmax')


def train_network(data, label, input_dim, class_dim=2, **kw):
    predict = stacked_lstm_net(data, input_dim, class_dim, **kw)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc
