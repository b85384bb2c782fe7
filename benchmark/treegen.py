"""Seeded file trees shaped like the Silesia corpus.

A tree is planned from the traffic file alone. Its ``files`` list the
corpus's files, each with its published size and the data class the
generator makes for it (English-like text, x86-like code with E8 calls,
database rows as CSV, XML records, noisy grey-scale image bytes). The tree
holds ``tree_bytes / corpus bytes`` rounds of that list, each file with
content of its own, then whole-file copies that make up ``dup_share`` of
all the bytes: the largest files that still fit, first. ``--seed`` changes
what the files hold and the order they lie in, never their sizes, so every
seed gives the archiver the same amount of work.

The bytes are made with torch on ``device`` (the card in a benchmark run)
from a ``torch.Generator`` seeded with ``--seed``, a few large calls a file.
"""

from __future__ import annotations

import pathlib
import random
import shutil
from dataclasses import dataclass
from typing import List, Sequence

import torch

CLASSES = ("text", "code", "csv", "xml", "image")
EXTENSION = {"text": "txt", "code": "exe", "csv": "csv", "xml": "xml",
             "image": "raw"}
#: English letter frequencies, per cent (a..z)
LETTER_FREQ = (8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15, 0.77, 4.0,
               2.4, 6.7, 7.5, 1.9, 0.095, 6.0, 6.3, 9.1, 2.8, 0.98, 2.4,
               0.15, 2.0, 0.074)
#: token draws of one call, so the index tensors stay bounded
_ROWS_PER_CALL = 1 << 20


@dataclass(frozen=True)
class FileSpec:
    name: str       # path under the tree's root, '/'-separated
    size: int
    kind: str       # one of CLASSES
    dup_of: int     # index of the file it copies, -1 for a unique file


def plan(traffic: dict, seed: int) -> List[FileSpec]:
    """The tree's files in name order. Sizes, classes and copies come from
    the traffic and are the same for every seed; ``seed`` only decides
    which name each file takes."""
    files = [(str(n), str(k), int(s)) for n, k, s in traffic["files"]]
    unknown = {k for _, k, _ in files} - set(CLASSES)
    if unknown:
        raise ValueError(f"unknown data classes {sorted(unknown)}")
    corpus = sum(s for _, _, s in files)
    total = int(traffic["tree_bytes"])
    if total <= 0 or total % corpus:
        raise ValueError(f"tree_bytes {total} is not a whole number of "
                         f"rounds of the {corpus} bytes of the file list")
    specs = [(s, k, n, -1) for _ in range(total // corpus)
             for n, k, s in files]
    dup = float(traffic["dup_share"])
    need = round(total * dup / (1 - dup))
    for i in sorted(range(len(specs)), key=lambda i: (-specs[i][0], i)):
        if 0 < specs[i][0] <= need:
            s, k, n, _ = specs[i]
            specs.append((s, k, n, i))
            need -= s
    order = list(range(len(specs)))
    random.Random(seed).shuffle(order)
    # file j of the tree (in name order) holds spec order[j]
    where = {spec: j for j, spec in enumerate(order)}
    out = []
    for j, i in enumerate(order):
        size, kind, name, src = specs[i]
        out.append(FileSpec(f"d{j // 16:03d}/f{j:05d}-{name}."
                            f"{EXTENSION[kind]}", size, kind,
                            -1 if src < 0 else where[src]))
    return out


class _Vocab:
    """Token strings as one flat byte tensor with offsets and lengths."""

    def __init__(self, tokens: Sequence[bytes], weights: Sequence[float],
                 device: torch.device):
        self.flat = torch.tensor(list(b"".join(tokens)), dtype=torch.uint8,
                                 device=device)
        lens = torch.tensor([len(t) for t in tokens], dtype=torch.int64)
        self.len = lens.to(device)
        self.off = (torch.cumsum(lens, 0) - lens).to(device)
        self.p = torch.tensor(weights, dtype=torch.float64, device=device)
        self.mean = float((lens.double() * self.p.cpu()).sum()
                          / self.p.sum().cpu())


def _zipf(n: int, s: float = 1.05) -> List[float]:
    return [1.0 / (k + 1) ** s for k in range(n)]


def _words(rng: random.Random, n: int) -> List[bytes]:
    letters = "abcdefghijklmnopqrstuvwxyz"
    out = set()
    while len(out) < n:
        k = min(12, 1 + int(rng.expovariate(1 / 4.5)))
        out.add("".join(rng.choices(letters, LETTER_FREQ, k=k)))
    words = sorted(out)
    rng.shuffle(words)
    return [w.encode() for w in words]


class Vocabularies:
    """Every class's token tables, drawn once per tree from the seed."""

    def __init__(self, seed: int, device: torch.device):
        rng = random.Random(seed)
        words = _words(rng, 8192)
        seps = [b" "] * 17 + [b", ", b". ", b".\n"]
        text = [w + rng.choice(seps) for w in words]
        self.text = [_Vocab(text, _zipf(len(text)), device)]
        first = [w.capitalize() for w in words[:600]]
        last = [w.capitalize() for w in words[600:2600]]
        names = [rng.choice(first) + b" " + rng.choice(last)
                 for _ in range(4000)]
        cities = [w.capitalize() for w in words[2600:3100]]
        cats = [w for w in words[3100:3124]]
        ids = [b"%09d" % rng.randrange(10 ** 9) for _ in range(50000)]
        amounts = [b"%d.%02d" % (int(rng.lognormvariate(4, 1.5)),
                                 rng.randrange(100)) for _ in range(20000)]
        dates = [b"20%02d-%02d-%02d" % (rng.randrange(10, 25),
                                        rng.randrange(1, 13),
                                        rng.randrange(1, 29))
                 for _ in range(3650)]

        def col(tokens, suffix, zipf=True):
            toks = [t + suffix for t in tokens]
            w = _zipf(len(toks), 0.8) if zipf else [1.0] * len(toks)
            return _Vocab(toks, w, device)

        self.csv = [col(ids, b",", zipf=False), col(names, b","),
                    col(cities, b","), col(amounts, b","), col(dates, b","),
                    col(cats, b"\n")]
        self.xml = [
            col([b"<record>\n  <id>" + i + b"</id>\n" for i in ids], b"",
                zipf=False),
            col([b"  <name>" + n + b"</name>\n" for n in names], b""),
            col([b"  <city>" + c + b"</city>\n" for c in cities], b""),
            col([b"  <amount currency=\"EUR\">" + a + b"</amount>\n"
                 for a in amounts], b""),
            col([b"  <date>" + d + b"</date>\n" for d in dates], b""),
            col([b"  <note>" + b" ".join(rng.sample(words[:3000], 6))
                 + b"</note>\n</record>\n" for _ in range(3000)], b""),
        ]
        # x86-like opcode bytes: a few very common, a long tail
        ops = list(range(256))
        rng.shuffle(ops)
        weights = _zipf(256, 1.2)
        for i, op in enumerate(ops):
            if op == 0xE8:
                weights[i] = 0.03 * sum(weights)   # calls
        self.opcodes = torch.tensor(ops, dtype=torch.uint8, device=device)
        self.opcode_p = torch.tensor(weights, dtype=torch.float64,
                                     device=device)


def _gather(v: List[_Vocab], rows: int, gen: torch.Generator
            ) -> torch.Tensor:
    """``rows`` rows of one token from each vocabulary of ``v``."""
    dev = v[0].flat.device
    flat = torch.cat([x.flat for x in v])
    base = 0
    cols_off, cols_len = [], []
    for x in v:
        ids = torch.multinomial(x.p, rows, replacement=True, generator=gen)
        cols_off.append(x.off[ids] + base)
        cols_len.append(x.len[ids])
        base += x.flat.numel()
    off = torch.stack(cols_off, 1).reshape(-1)
    lens = torch.stack(cols_len, 1).reshape(-1)
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1])
    shift = off - (ends - lens)
    idx = torch.repeat_interleave(shift, lens, output_size=total)
    idx += torch.arange(total, device=dev)
    return flat[idx]


def _tokens(v: List[_Vocab], n: int, gen: torch.Generator) -> torch.Tensor:
    row = sum(x.mean for x in v)
    parts, have = [], 0
    while have < n:
        rows = min(_ROWS_PER_CALL, int((n - have) / row * 1.05) + 8)
        parts.append(_gather(v, rows, gen))
        have += parts[-1].numel()
    return torch.cat(parts)[:n]


def _code(voc: Vocabularies, n: int, gen: torch.Generator) -> torch.Tensor:
    dev = voc.opcodes.device
    ids = torch.multinomial(voc.opcode_p, n, replacement=True, generator=gen)
    b = voc.opcodes[ids]
    pos = torch.nonzero(b == 0xE8).squeeze(1)
    pos = pos[pos + 5 <= n]
    if pos.numel():
        # keep calls whose operand no earlier call overwrites
        keep = torch.ones_like(pos, dtype=torch.bool)
        keep[1:] = pos[1:] - pos[:-1] >= 5
        pos = pos[keep]
        funcs = torch.randint(0, n, (512,), generator=gen, device=dev)
        target = funcs[torch.randint(0, 512, (pos.numel(),), generator=gen,
                                     device=dev)]
        rel = (target - (pos + 5)) % (1 << 32)
        for k in range(4):
            b[pos + 1 + k] = ((rel >> (8 * k)) & 255).to(torch.uint8)
    return b


def _image(n: int, gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    width = 1024
    h = -(-n // width)
    y = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    x = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    r = torch.rand(4, 4, generator=gen, device=dev)
    field = torch.full((h, width), 120.0, device=dev)
    for k in range(4):
        field += (20 * r[k, 0]) * torch.sin(
            0.02 * r[k, 1] * x + 0.02 * r[k, 2] * y + 6.28 * r[k, 3])
    field += 3.0 * torch.randn(h, width, generator=gen, device=dev)
    return field.round().clamp(0, 255).to(torch.uint8).reshape(-1)[:n]


def file_bytes(kind: str, n: int, voc: Vocabularies, gen: torch.Generator
               ) -> torch.Tensor:
    """``n`` bytes of class ``kind`` on the vocabularies' device."""
    if kind == "text":
        return _tokens(voc.text, n, gen)
    if kind == "csv":
        return _tokens(voc.csv, n, gen)
    if kind == "xml":
        return _tokens(voc.xml, n, gen)
    if kind == "code":
        return _code(voc, n, gen)
    if kind == "image":
        return _image(n, gen, voc.opcodes.device)
    raise ValueError(f"unknown data class {kind!r}")


def write_tree(traffic: dict, seed: int, root: pathlib.Path,
               device: torch.device) -> List[FileSpec]:
    """Write the tree under ``root``; returns its files in name order.
    Unique files are made first, then each copy from its source's file."""
    seed %= 1 << 63
    specs = plan(traffic, seed)
    voc = Vocabularies(seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for s in specs:
        (root / s.name).parent.mkdir(parents=True, exist_ok=True)
    for s in specs:
        if s.dup_of < 0:
            data = file_bytes(s.kind, s.size, voc, gen).cpu().numpy()
            (root / s.name).write_bytes(data.tobytes())
    for s in specs:
        if s.dup_of >= 0:
            shutil.copyfile(root / specs[s.dup_of].name, root / s.name)
    return specs
