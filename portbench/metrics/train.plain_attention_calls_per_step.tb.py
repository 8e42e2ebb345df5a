"""Full-sequence attention calls a template optimizer step that took the
plain path under a 3-D mask (the bond mask): the program's counter
`models/layers.py::PLAIN_MASK_3D_CALLS` over the traced slice, kept at the
graphs' replays. None where the program keeps no such counter."""


def read(facts):
    calls = facts.get("plain_attention_calls")
    if facts["kind"] != "train_template" or calls is None:
        return None
    return calls / facts["units"]
