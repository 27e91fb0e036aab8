"""repro_torch.core.codec against repro.core.codec: the same numpy inputs
through both packages, exact equality (every output is an integer)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import codec as J  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402

LENGTHS = [1, 15, 16, 17, 1000, 16384, 50001]


@pytest.mark.parametrize("n", LENGTHS)
def test_pack_unpack_match_reference(n):
    codes = C.random_dna(n, seed=n)
    np.testing.assert_array_equal(codes, J.random_dna(n, seed=n))
    got = C.pack_2bit(codes)
    assert got.dtype == torch.uint32
    want = np.asarray(J.pack_2bit(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    back = C.unpack_2bit(got, n)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(J.unpack_2bit(want, n)))
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("n_words", [1, 3, 8])
def test_extract_window_matches_reference(n, n_words):
    codes = C.random_dna(n, seed=n + 7)
    rng = np.random.default_rng(n * 10 + n_words)
    # word-aligned starts take the sh == 0 guard; the last positions read
    # past the end of the packed text
    pos = np.concatenate([rng.integers(0, n, size=64),
                          np.arange(0, n, 16)[:32],
                          np.arange(max(0, n - 20), n)]).astype(np.int32)
    got = C.extract_window(C.pack_2bit(codes), torch.from_numpy(pos),
                           n_words)
    want = J.extract_window(J.pack_2bit(codes), jnp.asarray(pos), n_words)
    assert got.dtype == torch.uint32 and got.shape == (len(pos), n_words)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("B,L", [(1, 1), (3, 15), (2, 16), (5, 17), (4, 33),
                                 (7, 128)])
def test_batch_pack_unpack_match_reference(B, L):
    rng = np.random.default_rng(B * 100 + L)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    words = C.pack_2bit_batch(codes)
    np.testing.assert_array_equal(words, J.pack_2bit_batch(codes))
    np.testing.assert_array_equal(C.unpack_2bit_batch(words, L),
                                  J.unpack_2bit_batch(words, L))
    with pytest.raises(ValueError):
        C.unpack_2bit_batch(words, words.shape[1] * 16 + 1)


def test_encode_decode_and_word_helpers():
    s = "ACGTacgtTTGA"
    np.testing.assert_array_equal(C.encode_dna(s), J.encode_dna(s))
    assert C.decode_dna(C.encode_dna(s)) == J.decode_dna(J.encode_dna(s))
    with pytest.raises(ValueError):
        C.encode_dna("ACGN")
    vals = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    words = C.words_u32(vals)
    assert words.dtype == torch.uint32
    np.testing.assert_array_equal(C.words_i64(words).numpy(), vals.numpy())
    assert C.packed_length(0) == 0 and C.packed_length(17) == 2
