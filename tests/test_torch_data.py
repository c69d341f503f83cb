"""The port's synthetic data stream (``data.SyntheticLM``) and non-IID
partition.

The stream is the port's own (a counter hash of (seed, step, client, row,
position) to uniforms, inverse CDF against the chain's rows), so it is
held to its definition rather than to the reference's threefry draws: a
deterministic function of (seed, step, client), ``batch`` equal to its
client's slice of ``batches``, labels the tokens shifted by one, and
transitions that follow softmax(T) by a chi-square test at significance
level 1e-3 (fixed seed).
"""
import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.data import SyntheticLM, dirichlet_partition, federated_batches
from repro_torch.scenarios import generator


def test_batches_are_a_function_of_seed_step_client():
    data = SyntheticLM(vocab_size=16, seq_len=6, seed=3, temperature=0.5)
    a = data.batch(4, 5, client_id=7)
    assert torch.equal(a["tokens"], data.batch(4, 5, client_id=7)["tokens"])
    assert torch.equal(a["tokens"], SyntheticLM(16, 6, 3, 0.5).batch(
        4, 5, client_id=7)["tokens"])
    for other in (data.batch(5, 5, client_id=7),
                  data.batch(4, 5, client_id=8),
                  SyntheticLM(16, 6, 4, 0.5).batch(4, 5, client_id=7)):
        assert not torch.equal(a["tokens"], other["tokens"])
    assert a["tokens"].shape == (5, 6) and a["tokens"].dtype == torch.int64
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 16
    # the first rows of a larger batch are the smaller batch
    assert torch.equal(data.batch(4, 9, client_id=7)["tokens"][:5],
                       a["tokens"])


def test_batch_is_its_clients_slice_of_batches():
    data = SyntheticLM(vocab_size=32, seq_len=8, seed=0, temperature=0.3)
    clients = np.arange(3)[:, None] * (1 << 20) + np.arange(5)[None, :]
    steps = np.arange(3)[:, None] * 10 + np.zeros((1, 5), np.int64)
    out = data.batches(steps, 4, clients)
    assert out["tokens"].shape == (3, 5, 4, 8)
    for i in range(3):
        for c in range(5):
            one = data.batch(int(steps[i, c]), 4, int(clients[i, c]))
            assert torch.equal(out["tokens"][i, c], one["tokens"])
            assert torch.equal(out["labels"][i, c], one["labels"])
    fed = federated_batches(data, 2, [1, 5], 4)
    assert torch.equal(fed["tokens"][1], data.batch(2, 4, 5)["tokens"])


def test_labels_are_tokens_shifted_by_one():
    data = SyntheticLM(vocab_size=16, seq_len=10, seed=1)
    b = data.batches(3, 6, np.arange(4))
    assert torch.equal(b["labels"][..., :-1], b["tokens"][..., 1:])


def test_table_is_drawn_on_the_cpu_from_the_seed():
    data = SyntheticLM(vocab_size=8, seq_len=4, seed=5, temperature=0.5)
    want = torch.randn((8, 8), generator=generator(5)) / 0.5
    assert torch.equal(data.transition_logits(), want)


def test_transitions_follow_the_chain():
    """Chi-square of the transition counts against softmax(T): every row's
    expected count is at least 5 here, and the test must not reject at
    significance level 1e-3."""
    v = 8
    data = SyntheticLM(vocab_size=v, seq_len=16, seed=11, temperature=1.0)
    b = data.batches(np.arange(64), 256, np.arange(64))
    prev = b["tokens"].reshape(-1).numpy()
    nxt = b["labels"].reshape(-1).numpy()
    counts = np.zeros((v, v))
    np.add.at(counts, (prev, nxt), 1)
    probs = torch.softmax(data.transition_logits().double(), dim=1).numpy()
    expected = counts.sum(axis=1, keepdims=True) * probs
    assert expected.min() >= 5
    chi2 = float(np.sum((counts - expected) ** 2 / expected))
    dof = v * (v - 1)
    p_value = stats.chi2.sf(chi2, dof)
    assert p_value > 1e-3, (chi2, dof, p_value)
    # the first tokens are uniform over the vocabulary
    first = b["tokens"][..., 0].reshape(-1).numpy()
    f_counts = np.bincount(first, minlength=v)
    assert stats.chisquare(f_counts).pvalue > 1e-3


def test_dirichlet_partition_ids_and_skew():
    def max_share(alpha):
        ids = dirichlet_partition(0, 4000, 10, 5, alpha).numpy()
        assert ids.min() >= 0 and ids.max() < 10 and ids.shape == (4000,)
        classes = np.arange(4000) % 5
        return np.mean([np.bincount(ids[classes == c], minlength=10).max()
                        / np.sum(classes == c) for c in range(5)])

    assert max_share(0.05) > max_share(1.0) > max_share(100.0)
    assert torch.equal(dirichlet_partition(3, 100, 4, 2),
                       dirichlet_partition(3, 100, 4, 2))


@pytest.mark.parametrize("seq_len", [1, 5])
def test_shapes_at_edges(seq_len):
    data = SyntheticLM(vocab_size=2, seq_len=seq_len)
    b = data.batch(0, 1)
    assert b["tokens"].shape == (1, seq_len)
    assert set(b["tokens"].unique().tolist()) <= {0, 1}
