"""repro_torch.core.suffix_array against repro.core.suffix_array and the
naive oracle: the suffix array must be bit-identical, DNA and tokens."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import suffix_array as J  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import suffix_array as S  # noqa: E402


def _codes(kind, n, seed):
    if kind == "dna":
        return C.random_dna(n, seed=seed)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 300, size=n).astype(np.int32)


@pytest.mark.parametrize("kind", ["dna", "tokens"])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 17, 257, 1500])
def test_sa_matches_reference_and_oracle(kind, n):
    codes = _codes(kind, n, seed=n + 1)
    got = S.build_suffix_array(codes)
    assert got.dtype == torch.int32 and got.shape == (n,)
    want = np.asarray(J.build_suffix_array(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), S.suffix_array_naive(codes))


@pytest.mark.parametrize("text", ["A" * 300, "ACGT" * 64 + "A", "TTTTTTTA",
                                  "MISSISSIPPI"],
                         ids=["A300", "ACGT64", "T7A", "MISSISSIPPI"])
def test_sa_on_repetitive_text_runs_every_round(text):
    """Long repeats keep ranks tied for many doubling rounds."""
    codes = np.frombuffer(text.encode(), dtype=np.uint8)
    got = S.build_suffix_array(codes).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.build_suffix_array(codes)))
    np.testing.assert_array_equal(got, S.suffix_array_naive(codes))


def test_rank_array_inverts_sa():
    codes = C.random_dna(999, seed=3)
    sa = S.build_suffix_array(codes)
    rank = S.rank_array(sa)
    np.testing.assert_array_equal(rank.numpy(),
                                  np.asarray(J.rank_array(sa.numpy())))
    np.testing.assert_array_equal(sa[rank.long()].numpy(), np.arange(999))
