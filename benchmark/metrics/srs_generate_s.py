"""The host span around Setup.generate in set-up."""

def read(run):
    return run.spans.get("srs_generate_s")
