"""Device milliseconds of the PDAS polish's Newton-Schulz chains per
replay of the cold batch's captured stage pair (one cold call), from the
stage clock's sub-stage rows (`fcc_qp_tpu_torch.utils.timing`: a stamp
pair around every chain site, summed over every replay; read by
`qpbench.chain_roofline.chain_sites`): ``polish_chain_ms.cold``, a part
of ``stage_ms.polish.cold``. None where the program keeps no sub-stage
sites (a program older than them), and on the CPU (no graph, no
stamp)."""


def read(rec: dict, name: str):
    from qpbench.chain_roofline import chain_sites

    got = chain_sites()
    if got is None:
        return None
    sites, replays = got
    return sum(s["ns"] for s in sites) / replays * 1e-6
