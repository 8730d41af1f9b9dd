"""The one traffic generator: a seed gives the same requests, another seed
the same sizes in another order with other tokens."""
import json
from collections import Counter
from pathlib import Path

import pytest

from portbench.harness.traffic import RequestStream, output_lengths, prompt_lengths

MIXES = Path(__file__).resolve().parents[1] / "traffic"


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def _take(stream, n):
    return [stream.spec(i) for i in range(n)]


@pytest.mark.parametrize("mix", ["docqa", "prefill"])
def test_same_seed_same_requests(mix):
    a, b = RequestStream(_mix(mix), 2**31 + 7, 151936), RequestStream(_mix(mix), 2**31 + 7, 151936)
    sa, sb = _take(a, 70), _take(b, 70)
    assert sa == sb
    assert all((a.tokens(x) == b.tokens(y)).all() for x, y in zip(sa[:5], sb[:5]))


@pytest.mark.parametrize("mix", ["docqa", "prefill"])
def test_seeds_differ_in_order_not_in_sizes(mix):
    m = _mix(mix)
    a, b = RequestStream(m, 11, 151936), RequestStream(m, 12, 151936)
    n = m["block"] * 3
    sa, sb = _take(a, n), _take(b, n)
    assert [x.prompt_len for x in sa] != [x.prompt_len for x in sb]
    assert (a.tokens(sa[0])[:16] != b.tokens(sb[0])[:16]).any()
    for blk in range(3):
        cut = slice(blk * m["block"], (blk + 1) * m["block"])
        for field in ("prompt_len", "max_new_tokens", "greedy"):
            assert Counter(getattr(x, field) for x in sa[cut]) == \
                Counter(getattr(x, field) for x in sb[cut])


def test_docqa_sizes():
    m = _mix("docqa")
    lens = prompt_lengths(m, 1000)
    assert min(lens) >= 1024 and max(lens) <= 8192
    assert any(n % 16 for n in lens)  # any length, not rounded to a page
    assert 3000 < sum(lens) / len(lens) < 4000  # a mean of about 3,500
    assert sorted(lens)[500] in range(3072, 3072 + 16 + 1)  # the median
    outs = output_lengths(m, 25)
    assert min(outs) == 8 and max(outs) == 32
    s = _take(RequestStream(m, 5, 151936), 32)
    assert sum(x.greedy for x in s) == 8
    assert all(x.temperature == 0.0 for x in s if x.greedy)
    assert all(x.k == 64 and x.temperature == 0.8 for x in s if not x.greedy)


@pytest.mark.parametrize("mix", ["docqa", "prefill"])
def test_lead_is_a_block_of_its_own(mix):
    """The clients' first wave is its own block; the mix's blocks start
    after it, each with the same lengths whatever the seed."""
    m = _mix(mix)
    n = m["block"]
    a, b = RequestStream(m, 21, 151936, lead=8), RequestStream(m, 22, 151936, lead=8)
    sa, sb = _take(a, 8 + 2 * n), _take(b, 8 + 2 * n)
    assert [x.index for x in sa] == list(range(8 + 2 * n))
    assert sorted(x.prompt_len for x in sa[:8]) == sorted(prompt_lengths(m, 8))
    for blk in range(2):
        cut = slice(8 + blk * n, 8 + (blk + 1) * n)
        assert sorted(x.prompt_len for x in sa[cut]) == sorted(prompt_lengths(m, n))
        assert Counter(x.prompt_len for x in sa[cut]) == Counter(x.prompt_len for x in sb[cut])
    assert [x.prompt_len for x in sa[8:8 + n]] != [x.prompt_len for x in sb[8:8 + n]]


def test_prefill_mixes_every_bucket():
    """A block of the MoE mix reaches every pow2 bucket from 1,024 to 8,192
    and can put four 8,192-bucket rows into one step of 8."""
    lens = prompt_lengths(_mix("prefill"), _mix("prefill")["block"])
    buckets = Counter(1 << (n - 1).bit_length() for n in lens)
    assert set(buckets) == {1024, 2048, 4096, 8192}
    assert buckets[8192] >= 4


def test_prefill_lengths_unrounded_and_one_token():
    m = _mix("prefill")
    lens = prompt_lengths(m, 1000)
    assert any(n % 16 for n in lens)
    assert {x.max_new_tokens for x in _take(RequestStream(m, 1, 151936), 16)} == {1}


def test_tokens_in_vocabulary():
    s = RequestStream(_mix("docqa"), 3, 1000)
    t = s.tokens(s.spec(0))
    assert t.dtype.name == "int32" and t.min() >= 0 and t.max() < 1000
    assert len(t) == s.spec(0).prompt_len
