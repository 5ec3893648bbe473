"""Paged KV cache: block pool, block tables, device-resident allocator.

Counterpart of ``repro/serving/kv_pool.py`` without prefix sharing. Each
attention layer keeps a pool of ``num_blocks`` fixed-size token blocks
``{"k": (num_blocks, bs, KV, hd), "v": ...}`` (float), or codes plus fp16
group scales ``{"k", "v": (num_blocks, bs, KV, packed_head), "k_scale",
"v_scale": (num_blocks, bs, KV, ng)}`` (quantized, ``quant/kv.py``); every
slot owns
a row of the shared block table ``(slots, max_blocks)`` mapping its logical
blocks to physical ids (``-1`` = unallocated). The allocator state is four
device tensors -- a free stack (``free`` + ``n_free``), per-block ``ref``
counts and the table -- and every transition is device-side
gather/scatter, so none of them makes the host wait for the card.

The allocator functions are functional like ``repro``'s (they return a new
state dict; the tensors are small). ``write_prompt_blocks`` writes the
pools IN PLACE: they are large.

Physical block 0 is the reserved garbage block: writes by rows that must
not touch the pool go there, and no valid table entry ever names it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.quant import kv as kv_codec

FLOAT_POOL_DTYPES = (torch.bfloat16, torch.float32)


def init_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
              dtype=torch.bfloat16, *, spec=None, device):
    """One attention layer's K/V block pool (unstacked), zero-filled.

    With ``spec`` (a ``quant.kv.KVQuantSpec``) the pool is quantized: codes
    plus fp16 group scales (the zero-filled garbage block dequantizes to
    exact zeros).
    """
    if spec is not None:
        if spec.head_dim != cfg.head_dim:
            raise ValueError(f"spec {spec} for head_dim {cfg.head_dim}")
        lead = (num_blocks, block_size, cfg.n_kv_heads)
        codes = dict(dtype=spec.code_dtype, device=device)
        scales = dict(dtype=spec.scale_dtype, device=device)
        return {"k": torch.zeros(lead + (spec.packed_head,), **codes),
                "v": torch.zeros(lead + (spec.packed_head,), **codes),
                "k_scale": torch.zeros(lead + (spec.num_groups,), **scales),
                "v_scale": torch.zeros(lead + (spec.num_groups,), **scales)}
    if dtype not in FLOAT_POOL_DTYPES:
        raise ValueError(f"float KV pools are bf16 or fp32, got {dtype}; "
                         f"integer storage goes through a KVQuantSpec")
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_alloc(num_blocks: int, slots: int, max_blocks: int, *, device):
    """Allocator state. Block 0 is the garbage block, so the free stack
    starts with blocks ``1 .. num_blocks-1`` (``n_free`` of them)."""
    i32 = dict(dtype=torch.int32, device=device)
    free = torch.cat([torch.arange(1, num_blocks, **i32),
                      torch.zeros((1,), **i32)])
    ref = torch.zeros((num_blocks,), **i32)
    ref[0] = 1
    return {
        "free": free,
        "n_free": torch.tensor(num_blocks - 1, **i32),
        "ref": ref,
        "table": torch.full((slots, max_blocks), -1, **i32),
    }


def _i32(t):
    return t.to(torch.int32)


def alloc_range(alloc, slot: int, start: int, n: int):
    """Pop ``n`` fresh blocks into ``table[slot, start:start+n]`` (ref=1).
    The caller guarantees ``n <= n_free`` (the engine sizes the pool so a
    full slot complement always fits)."""
    nb = alloc["free"].shape[0]
    mb = alloc["table"].shape[1]
    j = torch.arange(mb, device=alloc["free"].device)
    take = (j >= start) & (j < start + n)
    si = alloc["n_free"] - 1 - (j - start)
    ids = alloc["free"][torch.clamp(si, 0, nb - 1).long()]
    table = alloc["table"].clone()
    table[slot] = torch.where(take, ids, table[slot])
    return {
        "free": alloc["free"],
        "n_free": alloc["n_free"] - n,
        "ref": alloc["ref"].index_add(0, torch.where(take, ids, 0).long(),
                                      _i32(take)),
        "table": table,
    }


def free_slot(alloc, slot: int):
    """Retire a slot: decref every valid table entry, push blocks whose
    refcount hits 0 back on the stack (in row order), clear the row
    (``release_range`` over the whole row)."""
    return release_range(alloc, slot, 0, alloc["table"].shape[1])


def release_range(alloc, slot: int, start: int, n: int):
    """Release ``table[slot, start:start+n]``: decref every valid entry of
    the span, clear it to -1, and push blocks whose refcount hits 0 onto
    the free stack in row order (DESIGN.md §17), as ``repro``'s
    ``release_range``. A block another reference still holds keeps a
    positive count and stays off the stack, and a later release skips the
    cleared entries, so nothing is freed twice."""
    nb = alloc["free"].shape[0]
    mb = alloc["table"].shape[1]
    row = alloc["table"][slot]
    j = torch.arange(mb, device=row.device)
    take = (j >= start) & (j < start + n) & (row >= 0)
    safe = torch.where(take, row, 0).long()
    ref = alloc["ref"].index_add(0, safe, -_i32(take))
    freed = take & (ref[safe] == 0)
    rank = torch.cumsum(_i32(freed), 0) - 1
    # Junk lanes write free[nb-1] back to itself: the stack holds at most
    # nb-1 entries, so index nb-1 is never live.
    idx = torch.where(freed, alloc["n_free"] + rank, nb - 1).long()
    vals = torch.where(freed, safe, alloc["free"][nb - 1].long())
    free = alloc["free"].clone()
    free[idx] = _i32(vals)
    table = alloc["table"].clone()
    table[slot] = torch.where(take, -1, row)
    return {
        "free": free,
        "n_free": alloc["n_free"] + _i32(freed.sum()),
        "ref": ref,
        "table": table,
    }


def evict_out_of_window(alloc, first_live, live, sink_blocks: int):
    """In-tick out-of-window eviction (DESIGN.md §17): for every row in
    ``live``, release logical blocks ``sink_blocks <= j < first_live[row]``,
    the blocks the sliding window no longer reaches (``first_live`` from
    ``window.first_live_block``). Device-side tensor code only: no host
    round trip, so the tick keeps its one sync.

    Two rows may drop the same physical block in one call, so decrements
    are accumulated per physical block first and each block is pushed at
    most once, when its refcount reaches 0, in physical-id order (as
    ``repro``'s). Sink blocks and blocks with a surviving reference are
    never freed.
    """
    nb = alloc["free"].shape[0]
    tbl = alloc["table"]
    mb = tbl.shape[1]
    cols = torch.arange(mb, device=tbl.device)[None, :]
    ev = (live.to(torch.bool)[:, None] & (cols >= sink_blocks)
          & (cols < first_live[:, None]) & (tbl >= 0))
    ids = torch.where(ev, tbl, 0).long()
    dec = torch.zeros((nb,), dtype=torch.int32, device=tbl.device).index_add(
        0, ids.reshape(-1), _i32(ev.reshape(-1)))
    # junk lanes accumulate on the garbage block's id; a fill kernel, where
    # ``dec[0] = 0`` would copy the scalar from the host and synchronize
    dec[:1].zero_()
    ref = alloc["ref"] - dec
    freed = (dec > 0) & (ref == 0)
    rank = torch.cumsum(_i32(freed), 0) - 1
    # index nb-1 is never a live stack entry (the stack holds at most nb-1
    # blocks, in [0, nb-2]): junk lanes write its own value back to it
    idx = torch.where(freed, alloc["n_free"] + rank, nb - 1).long()
    vals = torch.where(freed, torch.arange(nb, dtype=torch.int32,
                                           device=tbl.device),
                       alloc["free"][nb - 1])
    free = alloc["free"].clone()
    free[idx] = vals
    return {
        "free": free,
        "n_free": alloc["n_free"] + _i32(freed.sum()),
        "ref": ref,
        "table": torch.where(ev, -1, tbl),
    }


def tick_alloc(alloc, pos, mask, block_size: int):
    """In-tick allocation: every row in ``mask`` whose position lies in an
    unallocated logical block pops one block off the free stack, on the
    device, with no host round trip."""
    nb = alloc["free"].shape[0]
    mb = alloc["table"].shape[1]
    b = pos.shape[0]
    lp = torch.clamp(pos, 0, mb * block_size - 1).long()
    blk = lp // block_size
    rows = torch.arange(b, device=pos.device)
    cur = alloc["table"][rows, blk]
    need = mask.to(torch.bool) & (cur < 0)
    rank = torch.cumsum(_i32(need), 0) - 1
    ids = alloc["free"][torch.clamp(alloc["n_free"] - 1 - rank, 0,
                                    nb - 1).long()]
    table = alloc["table"].clone()
    table[rows, blk] = torch.where(need, ids, cur)
    return {
        "free": alloc["free"],
        "n_free": alloc["n_free"] - _i32(need.sum()),
        "ref": alloc["ref"].index_add(0, torch.where(need, ids, 0).long(),
                                      _i32(need)),
        "table": table,
    }


def write_prompt_blocks(pool, k, v, row, start_blk: int, nblk: int,
                        block_size: int):
    """Scatter one slot's prompt K/V into a layer pool as whole blocks, IN
    PLACE.

    ``k``/``v``: the float prompt K/V, (S, KV, hd), padded here to a block
    multiple. A quantized pool quantizes them at this write site, and codes
    and scales take the same pad, reshape and scatter. Blocks ``start_blk
    <= j < nblk`` land at ``row[j]``; the rest (a shared prefix the slot
    must not overwrite, and the pad tail) go to the garbage block.
    """
    bs = block_size
    s = k.shape[0]
    spec = kv_codec.spec_from_cache(pool, k.shape[-1])
    if spec is not None:
        kc, ks = kv_codec.quantize_kv(k, spec)
        vc, vs = kv_codec.quantize_kv(v, spec)
        entries = {"k": kc, "v": vc, "k_scale": ks, "v_scale": vs}
    else:
        entries = {"k": k, "v": v}
    pad = (-s) % bs
    nblocks = (s + pad) // bs
    j = torch.arange(nblocks, device=row.device)
    write = (j >= start_blk) & (j < nblk)
    phys = torch.where(write, torch.clamp(row[:nblocks], min=0), 0).long()
    for name, x in entries.items():
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
        tgt = pool[name]
        tgt[phys] = x.reshape(nblocks, bs, *x.shape[1:]).to(tgt.dtype)
    return pool
