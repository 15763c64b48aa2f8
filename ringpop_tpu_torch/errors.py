"""Typed errors (reference: lib/errors.js plus per-module TypedErrors).

Each error carries a ``type`` string matching the reference's error types so
drivers/tests can dispatch on them the same way.

The port of ``ringpop_tpu/errors.py``.
"""

from __future__ import annotations

from typing import Any


class RingpopError(Exception):
    type = "ringpop.error"

    def __init__(self, message: str = "", **fields: Any):
        super().__init__(message or self.__doc__ or self.type)
        self.fields = fields
        for key, value in fields.items():
            setattr(self, key, value)


class OptionsRequiredError(RingpopError):
    """Expected `options` argument to be passed."""

    type = "ringpop.options-required"

    def __init__(self, method: str = ""):
        super().__init__(f"Expected `options` to be passed for method {method}", method=method)


class AppRequiredError(RingpopError):
    """Expected `options.app` to be a non-empty string."""

    type = "ringpop.options-app.required"


class HostPortRequiredError(RingpopError):
    """Expected `options.hostPort` to be valid."""

    type = "ringpop.options-host-port.required"

    def __init__(self, host_port: Any = None, reason: str = ""):
        super().__init__(
            f"Expected `options.hostPort` to be {reason}; got {host_port!r}",
            hostPort=host_port,
            reason=reason,
        )


class ArgumentRequiredError(RingpopError):
    type = "ringpop.argument-required"

    def __init__(self, argument: str = ""):
        super().__init__(f"Expected `{argument}` to be passed", argument=argument)


class FieldRequiredError(RingpopError):
    type = "ringpop.field-required"

    def __init__(self, argument: str = "", field: str = ""):
        super().__init__(
            f"Expected `{field}` to be defined on `{argument}`",
            argument=argument, field=field,
        )


class MethodRequiredError(RingpopError):
    type = "ringpop.method-required"

    def __init__(self, argument: str = "", method: str = ""):
        super().__init__(
            f"Expected `{method}` to be implemented by `{argument}`",
            argument=argument, method=method,
        )


class DuplicateHookError(RingpopError):
    type = "ringpop.duplicate-hook"

    def __init__(self, name: str = ""):
        super().__init__(f"Hook {name} already registered", name=name)


class PropertyRequiredError(RingpopError):
    type = "ringpop.options-property-required"

    def __init__(self, property: str = ""):
        super().__init__(f"Expected `{property}` to be defined", property=property)


class InvalidLocalMemberError(RingpopError):
    type = "ringpop.invalid-local-member"

    def __init__(self) -> None:
        super().__init__("Operation requires a local member")


class OptionRequiredError(RingpopError):
    type = "ringpop.option-required"

    def __init__(self, option: str = ""):
        super().__init__(f"Expected option `{option}`", option=option)


class InvalidOptionError(RingpopError):
    type = "ringpop.invalid-option"

    def __init__(self, option: str = "", reason: str = ""):
        super().__init__(f"Invalid option `{option}`: {reason}", option=option, reason=reason)


# -- join (lib/swim/join-sender.js:30-49) -----------------------------------


class JoinAbortedError(RingpopError):
    type = "ringpop.join-aborted"

    def __init__(self, reason: str = ""):
        super().__init__(f"Join aborted because `{reason}`", reason=reason)


class JoinDurationExceededError(RingpopError):
    type = "ringpop.join-duration-exceeded"

    def __init__(self, duration: float = 0, max: float = 0):
        super().__init__(
            f"Join duration of `{duration}` exceeded max `{max}`",
            duration=duration, max=max,
        )


class JoinAttemptsExceededError(RingpopError):
    type = "ringpop.join-attempts-exceeded"

    def __init__(self, join_attempts: int = 0, max_join_attempts: int = 0):
        super().__init__(
            f"Join attempts of `{join_attempts}` exceeded max `{max_join_attempts}`",
            joinAttempts=join_attempts,
            maxJoinAttempts=max_join_attempts,
        )


# -- join handler (server/join-handler.js:24-42) ----------------------------


class DenyJoinError(RingpopError):
    type = "ringpop.deny-join"

    def __init__(self) -> None:
        super().__init__("Node is currently configured to deny joins")


class InvalidJoinAppError(RingpopError):
    type = "ringpop.invalid-join.app"

    def __init__(self, expected: str = "", actual: str = ""):
        super().__init__(
            f"A node tried joining a different app cluster. "
            f"Expected ({expected}) actual ({actual}).",
            expected=expected,
            actual=actual,
        )


class InvalidJoinSourceError(RingpopError):
    type = "ringpop.invalid-join.source"

    def __init__(self, actual: str = ""):
        super().__init__(
            f"A node tried joining a cluster by attempting to join itself ({actual}).",
            actual=actual,
        )


class RedundantLeaveError(RingpopError):
    type = "ringpop.invalid-leave.redundant"

    def __init__(self) -> None:
        super().__init__("A node cannot leave its cluster when it has already left.")


# -- ping-req (lib/swim/ping-req-sender.js:25-55) ---------------------------


class BadPingReqPingStatusError(RingpopError):
    type = "ringpop.ping-req.bad-ping-status"

    def __init__(self, selected: str = "", target: str = "", ping_status: Any = None):
        super().__init__(
            f"Bad ping status from ping-req ping: {ping_status}",
            selected=selected,
            target=target,
            pingStatus=ping_status,
        )


class BadPingReqRespBodyError(RingpopError):
    type = "ringpop.ping-req.bad-resp-body"

    def __init__(self, selected: str = "", target: str = "", body: Any = None):
        super().__init__("Bad response from ping-req", selected=selected, target=target, body=body)


class NoMembersError(RingpopError):
    type = "ringpop.ping-req.no-members"

    def __init__(self) -> None:
        super().__init__("No selectable ping-req members")


class PingReqInconclusiveError(RingpopError):
    type = "ringpop.ping-req.inconclusive"

    def __init__(self) -> None:
        super().__init__("Ping-req is inconclusive")


class PingReqPingError(RingpopError):
    type = "ringpop.ping-req.ping"

    def __init__(self, err_message: str = ""):
        super().__init__(
            f"An error occurred on ping-req ping: {err_message}",
            errMessage=err_message,
        )


# -- request proxy (lib/request-proxy/{index,send}.js) ----------------------


class InvalidCheckSumError(RingpopError):
    type = "ringpop.request-proxy.invalid-checksum"

    def __init__(self, expected: Any = None, actual: Any = None):
        super().__init__(
            f"Expected the remote checksum to match local checksum. "
            f"Expected {expected} actual {actual}.",
            expected=expected,
            actual=actual,
        )


class MaxRetriesExceededError(RingpopError):
    type = "ringpop.request-proxy.max-retries-exceeded"

    def __init__(self, max_retries: int = 0):
        super().__init__(f"Max number of retries ({max_retries}) exceeded", maxRetries=max_retries)


class KeysDivergedError(RingpopError):
    type = "ringpop.request-proxy.keys-diverged"

    def __init__(self, keys: Any = None):
        super().__init__("Keys diverged during retry", keys=keys)


class ChannelDestroyedError(RingpopError):
    type = "ringpop.request-proxy.channel-destroyed"

    def __init__(self) -> None:
        super().__init__("Channel was destroyed")
