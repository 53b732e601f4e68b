"""Share of instances whose answer came from an accepted PDAS polish
(the program's `polish_accepted` counter): over the warm steps in the
replay, over every instance of a cold batch."""


def read(rec: dict, name: str):
    v = rec.get("polish_accepted")
    return None if v is None else 100.0 * v
