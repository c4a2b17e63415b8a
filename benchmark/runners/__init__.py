"""The entries that traffic mixes drive: a traffic file's `runner` names the
module here. Each exposes `Runner(config, traffic, seed, device, workdir)`."""
