"""The polish's Newton-Schulz chains' share of their roofline in the
cold calls, in %: the least time the card could take for the chains the
visited sites ran (`qpbench.chain_roofline.chain_work`) over the device
time the stage clock's sub-stage rows give them (the time of
``polish_chain_ms.cold``), both summed over every replay of the cold
pair: ``polish_chain_roofline.cold``. None where the program keeps no
sub-stage sites, and on the CPU."""


def read(rec: dict, name: str):
    from qpbench import chain_roofline, roofline

    got = chain_roofline.chain_sites()
    if got is None:
        return None
    sites, _ = got
    seconds = sum(s["ns"] for s in sites) * 1e-9
    if seconds <= 0:
        return None
    least = roofline.least_seconds(chain_roofline.chain_work(sites))
    return 100.0 * least["seconds"] / seconds
