"""Gossip peer discovery — the memberlist analog, dependency-free.

The reference embeds hashicorp/memberlist (memberlist.go:38-299): nodes
gossip membership over UDP, carry their PeerInfo as node metadata
(memberlist.go:126-151), and Join/Leave/Update callbacks maintain the peer
set.  No gossip library is baked into this image, so this module implements
a small push-gossip protocol directly on asyncio datagram endpoints:

- each node keeps a map  addr -> (PeerInfo, incarnation, last_heard);
- every `gossip_interval` it sends its full view (JSON) to `fanout` random
  peers; receivers merge entries with higher incarnations;
- a node refuting its own death bumps its incarnation (SWIM-style);
- entries unheard for `suspect_after` are marked dead and dropped after
  `reap_after`; an explicit `leave` message removes a node immediately.

Full-state push (not SWIM deltas) is O(n) per packet — fine for the tens of
peers a rate-limit cluster runs; the reference's WAN-tuned memberlist makes
the same simplicity/scale trade at small n.
"""
from __future__ import annotations

import asyncio
import json
import logging
import random
import time
from dataclasses import asdict
from typing import Dict, List, Optional, Sequence, Tuple

from gubernator_tpu_torch.core.types import PeerInfo
from gubernator_tpu_torch.discovery.base import Pool, UpdateFunc

log = logging.getLogger("gubernator_tpu_torch.discovery.gossip")


class _Member:
    __slots__ = (
        "info", "incarnation", "last_heard", "dead", "pinged_at", "probes"
    )

    def __init__(self, info: PeerInfo, incarnation: int) -> None:
        self.info = info
        self.incarnation = incarnation
        self.last_heard = time.monotonic()
        self.dead = False
        self.pinged_at: Optional[float] = None
        self.probes = 0


class GossipPool(Pool, asyncio.DatagramProtocol):
    def __init__(
        self,
        bind_address: str,  # "host:port" for the gossip UDP socket
        self_info: PeerInfo,
        on_update: UpdateFunc,
        seeds: Sequence[str] = (),  # other nodes' gossip addresses
        gossip_interval_s: float = 1.0,
        suspect_after_s: float = 5.0,
        reap_after_s: float = 10.0,
        fanout: int = 3,
        advertise_address: str = "",
    ) -> None:
        host, _, port = bind_address.rpartition(":")
        self.bind_host, self.bind_port = host or "0.0.0.0", int(port)
        # Identity must be ROUTABLE: a 0.0.0.0 bind would make every node
        # identify as the same unreachable address (memberlist advertises
        # a resolved address for the same reason, memberlist.go:96-124).
        if advertise_address:
            self.self_addr = advertise_address
        elif self.bind_host not in ("0.0.0.0", "::", ""):
            self.self_addr = bind_address
        else:
            from gubernator_tpu_torch.net.netutil import discover_ip

            self.self_addr = f"{discover_ip()}:{self.bind_port}"
        self.self_info = self_info
        self.on_update = on_update
        self.seeds = [s for s in seeds if s and s != bind_address]
        self.gossip_interval_s = gossip_interval_s
        self.suspect_after_s = suspect_after_s
        self.reap_after_s = reap_after_s
        self.fanout = fanout

        self._members: Dict[str, _Member] = {}
        self._incarnation = 1
        self._transport: Optional[asyncio.DatagramTransport] = None
        self._task: Optional[asyncio.Task] = None
        self._last_published: Optional[List[str]] = None

    # -- Pool ------------------------------------------------------------
    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: self, local_addr=(self.bind_host, self.bind_port)
        )
        self._members[self.self_addr] = _Member(
            self.self_info, self._incarnation
        )
        self._publish()
        # Eagerly push our state to the seeds (memberlist join,
        # memberlist.go:187-204).
        for seed in self.seeds:
            self._send_state(seed)
        self._task = asyncio.ensure_future(self._run())

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None
        if self._transport is not None:
            # Tell everyone we're leaving (memberlist Leave).
            msg = json.dumps(
                {"type": "leave", "addr": self.self_addr}
            ).encode()
            for addr in list(self._members):
                if addr != self.self_addr:
                    self._sendto(msg, addr)
            self._transport.close()
            self._transport = None

    # -- gossip loop -----------------------------------------------------
    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.gossip_interval_s)
            self._expire()
            targets = [
                a for a, m in self._members.items()
                if a != self.self_addr and not m.dead
            ]
            random.shuffle(targets)
            for addr in targets[: self.fanout]:
                self._send_state(addr)
            # Keep hammering seeds while we know no one (bootstrap).
            if not targets:
                for seed in self.seeds:
                    self._send_state(seed)

    def _suspect_threshold(self) -> float:
        """Suspicion window scaled with cluster size (memberlist-style).

        With full-state push to `fanout` random targets per interval, a
        given peer contacts us directly about every (n-1)/fanout rounds in
        expectation — a fixed window churns live nodes at tens of peers
        (P[no contact in 5 rounds] ~ 42% at n=20).  Three expected contact
        periods keeps the false-positive rate low at any n.
        """
        n = sum(1 for m in self._members.values() if not m.dead)
        return max(
            self.suspect_after_s,
            3.0 * self.gossip_interval_s * max(1.0, (n - 1) / self.fanout),
        )

    def _expire(self) -> None:
        now = time.monotonic()
        suspect_s = self._suspect_threshold()
        changed = False
        for addr, m in list(self._members.items()):
            if addr == self.self_addr:
                m.last_heard = now
                continue
            age = now - m.last_heard
            if age <= suspect_s:
                m.pinged_at = None
                m.probes = 0
            elif not m.dead:
                if m.pinged_at is None:
                    # Direct probe before declaring death (SWIM's ping):
                    # a live node acks with its state, refreshing
                    # last_heard before the grace below expires.
                    m.pinged_at = now
                    m.probes = 1
                    self._send_ping(addr)
                elif now - m.pinged_at > 2.0 * self.gossip_interval_s:
                    if m.probes < 3:
                        # Re-probe: one lost UDP ping or ack must not kill
                        # a live member (SWIM sends multiple probes before
                        # a death verdict; peer-list flaps churn the hash
                        # ring for everyone).
                        m.pinged_at = now
                        m.probes += 1
                        self._send_ping(addr)
                    else:
                        m.dead = True
                        changed = True
                        log.info("gossip: %s suspected dead", addr)
            if m.dead and age > suspect_s + self.reap_after_s:
                del self._members[addr]
                changed = True
        if changed:
            self._publish()

    # -- wire ------------------------------------------------------------
    def _state_msg(self) -> bytes:
        return json.dumps({
            "type": "state",
            "from": self.self_addr,
            "members": {
                addr: {
                    "info": asdict(m.info),
                    "inc": m.incarnation,
                    "dead": m.dead,
                }
                for addr, m in self._members.items()
            },
        }).encode()

    def _send_state(self, addr: str) -> None:
        self._sendto(self._state_msg(), addr)

    def _send_ping(self, addr: str) -> None:
        self._sendto(
            json.dumps({"type": "ping", "from": self.self_addr}).encode(),
            addr,
        )

    def _sendto(self, data: bytes, addr: str) -> None:
        if self._transport is None:
            return
        host, _, port = addr.rpartition(":")
        try:
            self._transport.sendto(data, (host.strip("[]"), int(port)))
        except OSError as e:
            log.debug("gossip send to %s failed: %s", addr, e)

    def datagram_received(self, data: bytes, _src: Tuple) -> None:
        try:
            msg = json.loads(data.decode())
        except (ValueError, UnicodeDecodeError):
            return
        if msg.get("type") == "ping":
            # Ack with our full state: the sender refreshes our liveness
            # from the `from` field and syncs membership in one packet.
            # A ping is direct contact — it also resurrects a member we
            # had marked dead (otherwise a pinging peer sits in dead-limbo:
            # last_heard keeps refreshing so it never reaps, but it never
            # rejoins the published peer list either).
            src = msg.get("from")
            if src:
                m = self._members.get(src)
                if m is not None:
                    m.last_heard = time.monotonic()
                    if m.dead:
                        m.dead = False
                        self._publish()
                self._send_state(src)
            return
        if msg.get("type") == "leave":
            addr = msg.get("addr")
            if addr in self._members and addr != self.self_addr:
                del self._members[addr]
                self._publish()
            return
        if msg.get("type") != "state":
            return
        changed = False
        for addr, ent in msg.get("members", {}).items():
            try:
                info = PeerInfo(**ent["info"])
                inc = int(ent["inc"])
                dead = bool(ent["dead"])
            except (KeyError, TypeError, ValueError):
                continue
            if addr == self.self_addr:
                # Refute reports of our death with a higher incarnation.
                if dead and inc >= self._incarnation:
                    self._incarnation = inc + 1
                    self._members[addr].incarnation = self._incarnation
                continue
            cur = self._members.get(addr)
            if cur is None:
                m = _Member(info, inc)
                m.dead = dead
                self._members[addr] = m
                changed = not dead
                if not dead:
                    log.info("gossip: joined %s", addr)
            else:
                if inc >= cur.incarnation:
                    # Liveness only refreshes on evidence the node itself
                    # produced: a HIGHER incarnation (it refuted a death).
                    # Relayed same-incarnation entries must NOT refresh
                    # last_heard, or a crashed node would be kept alive
                    # forever by peers echoing each other's stale state —
                    # direct contact (the `from` sender, below) is the
                    # only other liveness source (SWIM's direct probe).
                    if inc > cur.incarnation:
                        cur.last_heard = time.monotonic()
                        if cur.dead and not dead:
                            cur.dead = False
                            changed = True
                    if dead and not cur.dead and inc > cur.incarnation:
                        cur.dead = True
                        changed = True
                    cur.incarnation = inc
                    cur.info = info
        sender = msg.get("from")
        if sender in self._members:
            self._members[sender].last_heard = time.monotonic()
            if self._members[sender].dead:
                self._members[sender].dead = False
                changed = True
        if changed:
            self._publish()

    # -- membership -> peer list ----------------------------------------
    def _publish(self) -> None:
        peers = [
            m.info for m in self._members.values() if not m.dead
        ]
        peers.sort(key=lambda p: p.grpc_address)
        sig = [p.grpc_address for p in peers]
        if sig == self._last_published:
            return
        self._last_published = sig
        self.on_update(peers)

    def members(self) -> List[str]:
        return [a for a, m in self._members.items() if not m.dead]
